"""Bayesian hierarchical qualifying model on PyTorch.

The model of `monte_carlo_gp_tpu.models.bayesian`, with its flat parameter
layout, so a draw of either package means the same thing. For lap i with
team t(i), driver d(i) and circuit c(i):

    team_mu        ~ Normal(0, 1)
    team_sigma     ~ HalfNormal(0.5)
    team_effect_t  ~ Normal(team_mu, team_sigma)
    driver_sigma   ~ HalfNormal(0.3)
    driver_effect_d~ Normal(0, driver_sigma)
    circuit_sigma  ~ HalfNormal(0.2)
    circuit_eff_c  ~ Normal(0, circuit_sigma)
    sigma          ~ HalfNormal(0.1)
    y_i            ~ Normal(team_effect_{t(i)} + driver_effect_{d(i)}
                            + circuit_eff_{c(i)}, sigma)

where y is the lap's percentage gap to the fastest lap of its circuit. The
scales are sampled as logs (with the log-Jacobian) and the effects as
standard-normal raw vectors scaled inside the likelihood (non-centred).

The posterior is explored by Hamiltonian Monte Carlo: two warmup stages
with dual-averaged step sizes and a diagonal mass from a Welford estimate,
then sampling at a fixed step and mass. The chains are the leading
dimension of every tensor, each with its own step size, dual-averaging
state and mass. Everything is float32 on the given device. The log
posterior's gradient is written out by hand and sums in a fixed order on
either device: the per-row effects are gathered and scattered through a
dense one-hot design matrix (`X @ effects`, `resid @ X`), never through
indexed adds, whose float32 atomics on CUDA would make the posterior vary
from run to run. Every random number is drawn up front from a CPU
`torch.Generator` seeded with `seed`, so the same seed gives bitwise the
same posterior on a device, and a CPU and a CUDA fit draw the same numbers.

On a CUDA device every HMC transition of every chain is one launch of a
hand-written CUDA kernel (`ops/hmc_kernel.py`, `csrc/hmc_kernel.cu`: the
momentum, the whole leapfrog trajectory, logp at the proposal and the
accept, one block per chain, every sum in a fixed order), the counterpart
of the JAX model's compiled leapfrog loop; each warmup stage's starting
logp comes from the same kernel, and the adaptation between transitions
stays eager. On the CPU the kernel's wrapper runs the eager transition,
the plain version the kernel is held to (`sample_posterior(...,
plain=True)` runs it without the wrapper on any device).
`sample_posterior_graphed` replays one captured CUDA graph of the eager
transition per iteration instead (`GraphedTransition`, bitwise the eager
fit): the yardstick the kernel is timed against.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pandas as pd
import torch

from monte_carlo_gp_torch.models.quali_common import (
    needs_refit,
    rank_draws_to_probs,
    valid_q_rows,
)
from monte_carlo_gp_torch.ops import hmc_kernel
# the plain version of a transition, which the CPU fit runs
from monte_carlo_gp_torch.ops.hmc_kernel import hmc_transition_plain as _hmc_transition
from monte_carlo_gp_torch.utils.logging import log_event

# Prior scales.
TEAM_SIGMA_SCALE = 0.5
DRIVER_SIGMA_SCALE = 0.3
CIRCUIT_SIGMA_SCALE = 0.2
OBS_SIGMA_SCALE = 0.1

# Dual-averaging constants (Hoffman & Gelman 2014, table 1).
_DA_GAMMA = 0.05
_DA_T0 = 10.0
_DA_KAPPA = 0.75
_TARGET_ACCEPT = 0.8


# ---------------------------------------------------------------------------
# Design (host side, pandas to dense numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QualiDesign:
    """Indexed training rows of the hierarchical model. Vocabularies are in
    first-appearance order of the source frame (the archive is built in
    sorted event order, never from a Python set)."""

    y: np.ndarray  # (N,) float32 gap-to-fastest percent
    team_idx: np.ndarray  # (N,) int32
    driver_idx: np.ndarray  # (N,) int32
    circuit_idx: np.ndarray  # (N,) int32
    teams: tuple[str, ...]
    drivers: tuple[str, ...]
    circuits: tuple[str, ...]

    @property
    def n_rows(self) -> int:
        return int(self.y.shape[0])


def build_quali_design(laps: pd.DataFrame, session_type: str | None = "Q") -> QualiDesign:
    """The (gap %, team, driver, circuit) design of an archive frame: each
    usable lap's percentage gap to the fastest lap of its circuit, and
    integer indices into the team, driver and circuit vocabularies.

    `session_type` filters the archive ("Q" by default; None trains on all
    laps); the filter and its errors are `quali_common.valid_q_rows`'s."""
    rows = valid_q_rows(laps, session_type)

    lap_s = rows["LapTime"].to_numpy(np.float64)
    fastest = rows.groupby("circuit")["LapTime"].transform("min").to_numpy(np.float64)
    gap = (lap_s - fastest) / fastest * 100.0

    teams = tuple(pd.unique(rows["Team"]))
    drivers = tuple(pd.unique(rows["Driver"]))
    circuits = tuple(pd.unique(rows["circuit"]))
    team_map = {t: i for i, t in enumerate(teams)}
    driver_map = {d: i for i, d in enumerate(drivers)}
    circuit_map = {c: i for i, c in enumerate(circuits)}

    return QualiDesign(
        y=gap.astype(np.float32),
        team_idx=rows["Team"].map(team_map).to_numpy(np.int32),
        driver_idx=rows["Driver"].map(driver_map).to_numpy(np.int32),
        circuit_idx=rows["circuit"].map(circuit_map).to_numpy(np.int32),
        teams=teams,
        drivers=drivers,
        circuits=circuits,
    )


# ---------------------------------------------------------------------------
# Log posterior (unconstrained, non-centred)
# ---------------------------------------------------------------------------

# Flat parameter vector layout: [team_mu, log team_sigma, log driver_sigma,
# log circuit_sigma, log obs_sigma, team_raw (T), driver_raw (D),
# circuit_raw (C)].
_N_SCALAR = 5
_PRIOR_SCALES = (TEAM_SIGMA_SCALE, DRIVER_SIGMA_SCALE, CIRCUIT_SIGMA_SCALE, OBS_SIGMA_SCALE)


def _param_dim(design: QualiDesign) -> int:
    return _N_SCALAR + len(design.teams) + len(design.drivers) + len(design.circuits)


def _unpack(theta: torch.Tensor, sizes: tuple[int, int, int]):
    """The parts of `theta` (..., dim) along its last axis."""
    t, d, c = sizes
    team_mu = theta[..., 0]
    log_sigmas = theta[..., 1:_N_SCALAR]
    team_raw = theta[..., _N_SCALAR : _N_SCALAR + t]
    driver_raw = theta[..., _N_SCALAR + t : _N_SCALAR + t + d]
    circuit_raw = theta[..., _N_SCALAR + t + d : _N_SCALAR + t + d + c]
    return team_mu, log_sigmas, team_raw, driver_raw, circuit_raw


def constrain(theta: torch.Tensor, sizes: tuple[int, int, int]) -> dict:
    """Unconstrained vectors (..., dim) to the named constrained
    parameters."""
    team_mu, log_sigmas, team_raw, driver_raw, circuit_raw = _unpack(theta, sizes)
    sig = torch.exp(log_sigmas)
    return {
        "team_mu": team_mu,
        "team_sigma": sig[..., 0],
        "driver_sigma": sig[..., 1],
        "circuit_sigma": sig[..., 2],
        "sigma": sig[..., 3],
        "team_effect": team_mu[..., None] + sig[..., 0:1] * team_raw,
        "driver_effect": sig[..., 1:2] * driver_raw,
        "circuit_effect": sig[..., 2:3] * circuit_raw,
    }


def make_log_posterior(design: QualiDesign, device: str | torch.device = "cuda"):
    """(logp, grad, sizes): the log posterior of a (chains, dim) float32
    batch of unconstrained vectors, as a (chains,) tensor, and its gradient,
    as a (chains, dim) tensor, both on `device`.

    HalfNormal(s; scale) with s = exp(u) contributes -s²/(2·scale²) + u (the
    log density up to constants, plus the log-Jacobian of exp). The raw
    effect vectors are standard normal; the likelihood applies the scales.
    The effects reach the rows through `x`, the (N, T + D + C) one-hot
    design matrix, and the rows' residuals reach the effects through `x`
    again: products with a fixed summation order on every device (they
    assume float32 matmuls, PyTorch's default, not TF32)."""
    dev = torch.device(device)
    sizes = (len(design.teams), len(design.drivers), len(design.circuits))
    t, d, c = sizes
    n, k = design.n_rows, t + d + c
    x_np = np.zeros((n, k), np.float32)
    rows = np.arange(n)
    x_np[rows, design.team_idx] = 1.0
    x_np[rows, t + design.driver_idx] = 1.0
    x_np[rows, t + d + design.circuit_idx] = 1.0
    segment = np.repeat(np.arange(3), sizes)  # the scale each raw column takes
    x = torch.from_numpy(x_np).to(dev)
    xt = x.t().contiguous()
    neg_y = torch.from_numpy(-design.y).to(dev)
    seg_index = torch.from_numpy(segment).to(dev)
    # (k, 4): the sums of a row's raw columns per scale; the fourth scale
    # (the observation noise) has no raw column
    seg_onehot = torch.from_numpy(np.eye(4, dtype=np.float32)[segment]).to(dev)
    team_mask = torch.from_numpy((segment == 0).astype(np.float32)).to(dev)
    obs_mask = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    prior_prec = torch.tensor([s**-2 for s in _PRIOR_SCALES], dtype=torch.float32, device=dev)

    def effects(theta):
        """The parts of theta, the scales, each raw column's scale, the
        rows' mu - y (chains, n) and 1 / sigma² (chains,)."""
        team_mu, log_sigmas, raw = theta[:, 0], theta[:, 1:_N_SCALAR], theta[:, _N_SCALAR:]
        sig = torch.exp(log_sigmas)
        scale = sig[:, seg_index]  # (chains, k)
        eff = torch.addcmul(team_mu[:, None] * team_mask, raw, scale)
        err = eff @ xt
        err += neg_y
        return team_mu, log_sigmas, raw, sig, scale, err, torch.exp(-2.0 * log_sigmas[:, 3])

    def logp(theta: torch.Tensor) -> torch.Tensor:
        team_mu, log_sigmas, raw, sig, _, err, inv_var = effects(theta)
        lp = -0.5 * team_mu**2
        lp = lp + torch.sum(-0.5 * sig**2 * prior_prec + log_sigmas, dim=1)
        lp = lp - 0.5 * torch.sum(raw**2, dim=1)
        return lp - 0.5 * torch.sum(err**2, dim=1) * inv_var - n * log_sigmas[:, 3]

    def grad(theta: torch.Tensor) -> torch.Tensor:
        team_mu, _, raw, sig, scale, err, inv_var = effects(theta)
        g_eff = (err @ x) * -inv_var[:, None]  # d logp / d effect, (chains, k)
        g_mu = g_eff[:, :t].sum(dim=1) - team_mu
        # d logp / d log sigma: the prior's 1 - (sigma / scale)², each effect
        # scale's sum of d logp / d effect · raw, and the likelihood's
        # sum(resid²) - n for the observation noise
        g_log_sig = torch.addcmul(1.0 - sig**2 * prior_prec, sig, (g_eff * raw) @ seg_onehot)
        g_obs = torch.sum(err**2, dim=1) * inv_var - n
        g_log_sig = torch.addcmul(g_log_sig, g_obs[:, None], obs_mask)
        g_raw = torch.addcmul(-raw, scale, g_eff)
        return torch.cat([g_mu[:, None], g_log_sig, g_raw], dim=1)

    return logp, grad, sizes


# ---------------------------------------------------------------------------
# HMC with warmup adaptation; chains are the leading dimension
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransitionBuffers:
    """The static tensors of one transition: its inputs theta (chains, dim),
    lp (chains,), eps (chains,), inv_mass (chains, dim), z (chains, dim),
    u_jit and u_acc (chains,), and its outputs, written back into theta and
    lp, with alpha (chains,)."""

    theta: torch.Tensor
    lp: torch.Tensor
    eps: torch.Tensor
    inv_mass: torch.Tensor
    z: torch.Tensor
    u_jit: torch.Tensor
    u_acc: torch.Tensor
    alpha: torch.Tensor

    @classmethod
    def zeros(cls, chains: int, dim: int, device) -> "TransitionBuffers":
        """Buffers holding a finite placeholder state (theta 0, step 0.1,
        unit mass), so that runs before the first real inputs stay finite."""
        f32 = dict(dtype=torch.float32, device=device)
        return cls(
            theta=torch.zeros(chains, dim, **f32), lp=torch.zeros(chains, **f32),
            eps=torch.full((chains,), 0.1, **f32), inv_mass=torch.ones(chains, dim, **f32),
            z=torch.zeros(chains, dim, **f32), u_jit=torch.zeros(chains, **f32),
            u_acc=torch.zeros(chains, **f32), alpha=torch.zeros(chains, **f32),
        )

    def load(self, theta, lp, eps, inv_mass, z, u_jit, u_acc) -> None:
        """Copy a transition's inputs into the buffers (a buffer passed as
        its own input is left as it is)."""
        for dst, src in ((self.theta, theta), (self.lp, lp), (self.eps, eps),
                         (self.inv_mass, inv_mass), (self.z, z), (self.u_jit, u_jit),
                         (self.u_acc, u_acc)):
            if dst is not src:
                dst.copy_(src)


def _transition_into(buf: TransitionBuffers, logp_fn, grad_fn, n_leapfrog: int) -> None:
    """`_hmc_transition` on the inputs in `buf`, its (theta', lp', alpha)
    copied back into buf.theta, buf.lp and buf.alpha: what the CUDA graph
    records. Every buffer keeps its storage, so a replay reads and writes
    the same addresses."""
    theta, lp, alpha = _hmc_transition(
        buf.theta, buf.lp, buf.eps, buf.inv_mass, logp_fn, grad_fn, n_leapfrog,
        buf.z, buf.u_jit, buf.u_acc,
    )
    buf.theta.copy_(theta)
    buf.lp.copy_(lp)
    buf.alpha.copy_(alpha)


# replays of a captured transition in this process (`GraphedTransition`)
transition_replays = 0
# eager runs of the captured function before its capture
_GRAPH_WARMUP_RUNS = 3


class GraphedTransition:
    """One HMC transition of (chains, dim) float32 chains on a CUDA device,
    captured once as a CUDA graph and replayed per call; a call takes and
    returns what `_hmc_transition` does, bitwise.

    The graph holds all of `_hmc_transition`: the momentum from z, the step
    jitter, the leapfrog trajectory with its gradients, logp of the
    proposal, the kinetic energies, alpha and the accept. It reads the
    static inputs of `TransitionBuffers` and the design tensors that
    `logp_fn` and `grad_fn` close over, by address: those stay alive with
    the graph. A call copies its inputs into the buffers, replays on the
    current stream and returns the buffers (theta, lp, alpha), which the
    next call overwrites. Products stay full float32, as in the eager
    transition: the graph records whatever `torch.backends.cuda.matmul.
    allow_tf32` (False by default) selects at capture. A capture that fails
    raises; there is no eager fallback. `close` releases the graph and its
    memory pool."""

    def __init__(self, logp_fn, grad_fn, n_leapfrog: int, chains: int, dim: int, device):
        self.buf = TransitionBuffers.zeros(chains, dim, device)
        self.graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(self.graph)

        def record():
            _transition_into(self.buf, logp_fn, grad_fn, n_leapfrog)

        # Warm-up on the capture stream, outside the capture: cuBLAS takes
        # its handle and this stream's workspace here. The buffers hold only
        # the placeholder state; every call loads its own inputs.
        stream, current = capture.capture_stream, torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            for _ in range(_GRAPH_WARMUP_RUNS):
                record()
        current.wait_stream(stream)
        with capture:
            record()

    def __call__(self, theta, lp, eps, inv_mass, z, u_jit, u_acc):
        global transition_replays
        buf = self.buf
        buf.load(theta, lp, eps, inv_mass, z, u_jit, u_acc)
        self.graph.replay()
        transition_replays += 1
        return buf.theta, buf.lp, buf.alpha

    def close(self) -> None:
        """Wait for the replays, then free the graph and return its private
        memory pool to the device."""
        torch.cuda.synchronize(self.buf.theta.device)
        self.graph.reset()
        torch.cuda.empty_cache()


def _warmup_stage(theta, logp_fn, step, inv_mass, eps0, draws):
    """One warmup stage over len(draws[0]) iterations, each a
    `step(theta, lp, eps, inv_mass, z, u_jit, u_acc) -> (theta, lp, alpha)`:
    each chain's step size dual-averaged at a fixed `inv_mass`, and a
    Welford variance of its draws over the stage's second half (the next
    stage's and the sampler's diagonal mass). Returns (theta, lp, eps, var,
    mean alpha)."""
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
        h_bar = (1.0 - 1.0 / (m + _DA_T0)) * h_bar + (_TARGET_ACCEPT - alpha) / (m + _DA_T0)
        log_eps = mu - math.sqrt(m) / _DA_GAMMA * h_bar
        w = m ** (-_DA_KAPPA)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
        if it >= half:  # Welford over the stage's second half
            w_n += 1
            delta = theta - w_mean
            w_mean = w_mean + delta / w_n
            w_m2 = w_m2 + delta * (theta - w_mean)
    var = w_m2 / (w_n - 1) if w_n > 1 else torch.ones_like(theta)
    var = var.clamp(1e-4, 1e4)
    return theta, lp, torch.exp(log_eps_bar), var, alpha_sum / n_iters


def _schedule(theta0, logp_fn, step, n_warmup: int, n_samples: int, draws):
    """The full schedule of every chain, each transition a `step` (see
    `_warmup_stage`): two warmup stages (identity mass, then the first
    stage's Welford mass), then sampling at a fixed step size and mass.
    Returns (samples (samples, chains, dim), accept rate (chains,))."""
    w1 = max(n_warmup // 2, 1)
    w2 = max(n_warmup - w1, 1)
    stage1 = tuple(a[:w1] for a in draws)
    stage2 = tuple(a[w1 : w1 + w2] for a in draws)
    z, u_jit, u_acc = (a[w1 + w2 :] for a in draws)
    chains = theta0.shape[0]
    eps0 = torch.full((chains,), 0.1, dtype=torch.float32, device=theta0.device)
    theta, _, eps, var, _ = _warmup_stage(
        theta0, logp_fn, step, torch.ones_like(theta0), eps0, stage1
    )
    inv_mass = var  # the optimal diagonal M^-1 is about the posterior variance
    theta, lp, eps, _, _ = _warmup_stage(theta, logp_fn, step, inv_mass, eps, stage2)
    samples = torch.empty((n_samples, *theta.shape), dtype=theta.dtype, device=theta.device)
    alpha_sum = torch.zeros_like(eps)
    for i in range(n_samples):
        theta, lp, alpha = step(theta, lp, eps, inv_mass, z[i], u_jit[i], u_acc[i])
        samples[i] = theta
        alpha_sum = alpha_sum + alpha
    return samples, alpha_sum / n_samples


def kernel_design(design: QualiDesign, device, plain=None) -> hmc_kernel.KernelDesign:
    """The design's rows as the HMC kernel reads them on `device`, with the
    plain log posterior (`plain`: make_log_posterior's (logp, grad) on that
    device, made here when None)."""
    dev = torch.device(device)
    if plain is None:
        plain = make_log_posterior(design, dev)[:2]
    sizes = (len(design.teams), len(design.drivers), len(design.circuits))
    return hmc_kernel.kernel_design(design.y, design.team_idx, design.driver_idx,
                                    design.circuit_idx, sizes, _PRIOR_SCALES, *plain, dev)


def _eager_step(logp_fn, grad_fn, n_leapfrog: int):
    """`_hmc_transition` on `logp_fn` and `grad_fn` as a `_schedule` step."""
    def step(theta, lp, eps, inv_mass, z, u_jit, u_acc):
        return _hmc_transition(theta, lp, eps, inv_mass, logp_fn, grad_fn, n_leapfrog,
                               z, u_jit, u_acc)

    return step


def _run_chains(theta0, logp_fn, grad_fn, n_warmup: int, n_samples: int, n_leapfrog: int, draws,
                kernel: hmc_kernel.KernelDesign | None = None):
    """`_schedule` with `n_leapfrog` steps per transition. With `kernel` (the
    design as the HMC kernel reads it, on theta0's device) each transition
    is `hmc_kernel.hmc_transition` and each stage's starting logp
    `hmc_kernel.hmc_logp`: one launch of the kernel each on a CUDA device,
    their plain versions on the CPU. Without it each transition is
    `_hmc_transition` run eagerly."""
    if kernel is None:
        step = _eager_step(logp_fn, grad_fn, n_leapfrog)
        return _schedule(theta0, logp_fn, step, n_warmup, n_samples, draws)

    def launch(theta, lp, eps, inv_mass, z, u_jit, u_acc):
        return hmc_kernel.hmc_transition(kernel, theta, lp, eps, inv_mass, z, u_jit, u_acc,
                                         n_leapfrog)

    def logp(theta):
        return hmc_kernel.hmc_logp(kernel, theta)

    return _schedule(theta0, logp, launch, n_warmup, n_samples, draws)


def _run_graphed(theta0, logp_fn, grad_fn, n_warmup: int, n_samples: int, n_leapfrog: int,
                 draws):
    """`_run_chains` run eagerly, but on a CUDA device every transition a
    replay of one `GraphedTransition`, released before this returns."""
    if not theta0.is_cuda:
        return _run_chains(theta0, logp_fn, grad_fn, n_warmup, n_samples, n_leapfrog, draws)
    graphed = GraphedTransition(logp_fn, grad_fn, n_leapfrog, *theta0.shape, theta0.device)
    try:
        return _schedule(theta0, logp_fn, graphed, n_warmup, n_samples, draws)
    finally:
        graphed.close()


def chain_draws(seed: int, num_chains: int, dim: int, n_iters: int):
    """Every random number of a fit, from one CPU generator seeded with
    `seed`: the initial jitter (chains, dim), then per iteration the momenta
    (n_iters, chains, dim) and the step-jitter and acceptance uniforms
    (n_iters, chains) each."""
    gen = torch.Generator().manual_seed(seed)
    init = torch.randn(num_chains, dim, generator=gen)
    z = torch.randn(n_iters, num_chains, dim, generator=gen)
    u = torch.rand(n_iters, 2, num_chains, generator=gen)
    return init, (z, u[:, 0], u[:, 1])


@dataclasses.dataclass(frozen=True)
class QualiPosterior:
    """Posterior draws (chains flattened) in constrained space, plus
    per-chain diagnostics. `raw` keeps (chains, samples, dim) for R-hat."""

    design: QualiDesign
    team_effect: np.ndarray  # (S, T)
    driver_effect: np.ndarray  # (S, D)
    circuit_effect: np.ndarray  # (S, C)
    team_mu: np.ndarray  # (S,)
    driver_sigma: np.ndarray  # (S,)
    sigma: np.ndarray  # (S,)
    accept_rate: np.ndarray  # (chains,)
    raw: np.ndarray  # (chains, samples, dim)

    @property
    def n_draws(self) -> int:
        return int(self.sigma.shape[0])


def sample_posterior(
    design: QualiDesign,
    num_chains: int = 4,
    num_warmup: int = 1000,
    num_samples: int = 1000,
    num_leapfrog: int = 48,
    seed: int = 42,
    device: str | torch.device = "cuda",
    *,
    plain: bool = False,
) -> QualiPosterior:
    """Fit the hierarchical model on `device` (a CUDA device raises where
    there is none). The same seed on the same device gives bitwise the same
    `raw`. Every transition goes through the HMC kernel's wrapper
    (`hmc_kernel.hmc_transition`) and each warmup stage's starting logp
    through its logp entry: on a CUDA device one launch of the kernel each
    (counted in their `launches`; a refusal or a failed launch raises
    `hmc_kernel.HMCKernelError`), on the CPU their plain versions. `plain`
    runs the transitions eagerly without the wrapper on any device, the
    plain version the kernel is held to."""
    def run(theta0, logp_fn, grad_fn, *schedule):
        kernel = None if plain else kernel_design(design, theta0.device, (logp_fn, grad_fn))
        return _run_chains(theta0, logp_fn, grad_fn, *schedule, kernel=kernel)

    return _fit(design, num_chains, num_warmup, num_samples, num_leapfrog, seed, device, run)


def sample_posterior_graphed(
    design: QualiDesign,
    num_chains: int = 4,
    num_warmup: int = 1000,
    num_samples: int = 1000,
    num_leapfrog: int = 48,
    seed: int = 42,
    device: str | torch.device = "cuda",
) -> QualiPosterior:
    """`sample_posterior` with every transition on a CUDA device a replay of
    one captured CUDA graph of the eager transition (`GraphedTransition`,
    counted in `transition_replays`), bitwise the `plain` fit: the yardstick
    the kernel is timed against. The CPU runs the transitions eagerly."""
    return _fit(design, num_chains, num_warmup, num_samples, num_leapfrog, seed, device,
                _run_graphed)


def _fit(design: QualiDesign, num_chains: int, num_warmup: int, num_samples: int,
         num_leapfrog: int, seed: int, device, run) -> QualiPosterior:
    """`sample_posterior` with its schedule run by `run(theta0, logp_fn,
    grad_fn, n_warmup, n_samples, n_leapfrog, draws) -> (samples, accept)`
    (`_run_chains`, `_run_graphed`)."""
    dev = torch.device(device)
    logp_fn, grad_fn, sizes = make_log_posterior(design, dev)
    dim = _param_dim(design)
    # Jittered inits: raws near 0, log-scales near log(prior scale / 2).
    offsets = np.zeros(dim, np.float32)
    offsets[1:_N_SCALAR] = np.log(np.asarray(_PRIOR_SCALES, np.float32) / 2)
    w1 = max(num_warmup // 2, 1)
    n_iters = w1 + max(num_warmup - w1, 1) + num_samples
    init, draws = chain_draws(seed, num_chains, dim, n_iters)
    with torch.inference_mode():  # no autograd bookkeeping on ~10^5 small ops
        theta0 = (torch.from_numpy(offsets) + 0.1 * init).to(dev)
        draws = tuple(a.to(dev) for a in draws)
        samples, accept = run(theta0, logp_fn, grad_fn, int(num_warmup), int(num_samples),
                              int(num_leapfrog), draws)
        raw = samples.transpose(0, 1).cpu().numpy()  # (chains, samples, dim)
        accept = accept.cpu().numpy()
    con = constrain(torch.from_numpy(raw.reshape(num_chains * num_samples, dim)), sizes)
    return QualiPosterior(
        design=design,
        team_effect=con["team_effect"].numpy(),
        driver_effect=con["driver_effect"].numpy(),
        circuit_effect=con["circuit_effect"].numpy(),
        team_mu=con["team_mu"].numpy(),
        driver_sigma=con["driver_sigma"].numpy(),
        sigma=con["sigma"].numpy(),
        accept_rate=accept,
        raw=raw,
    )


def split_rhat(chains_samples: np.ndarray) -> np.ndarray:
    """Split-R-hat (Gelman et al.) per parameter from (chains, samples, dim)
    draws."""
    c, s, d = chains_samples.shape
    half = s // 2
    halves = np.concatenate(
        [chains_samples[:, :half], chains_samples[:, half : 2 * half]], axis=0
    )  # (2c, half, d)
    m, n = halves.shape[0], halves.shape[1]
    chain_means = halves.mean(axis=1)  # (2c, d)
    chain_vars = halves.var(axis=1, ddof=1)  # (2c, d)
    w = chain_vars.mean(axis=0)
    b = n * chain_means.var(axis=0, ddof=1)
    var_hat = (n - 1) / n * w + b / n
    return np.sqrt(var_hat / np.maximum(w, 1e-12))


# ---------------------------------------------------------------------------
# Posterior to qualifying grid probabilities
# ---------------------------------------------------------------------------


def predictive_draws(n_draws: int, n_drivers: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The two standard-normal (n_draws, n_drivers) float32 draws of
    `quali_position_probs`, rookie effects then session noise, from a CPU
    generator seeded with `seed`."""
    gen = torch.Generator().manual_seed(seed)
    rookie_z = torch.randn(n_draws, n_drivers, generator=gen)
    noise = torch.randn(n_draws, n_drivers, generator=gen)
    return rookie_z.numpy(), noise.numpy()


def quali_position_probs(
    posterior: QualiPosterior,
    drivers: list[str],
    driver_teams: dict[str, str | None],
    circuit: str,
    seed: int = 0,
    draws: tuple[np.ndarray, np.ndarray] | None = None,
) -> dict[str, list[float]]:
    """Posterior-predictive grid-position distributions of a weekend field.

    For every posterior draw each driver's gap is team_effect +
    driver_effect + circuit_effect plus Normal(0, sigma) session noise;
    ranking the draws gives one grid each, and averaging the one-hot grids
    gives each driver's position distribution, in the form of the Elo
    qualifying path. A driver absent from the archive draws its effect from
    Normal(0, driver_sigma[s]) per draw, an unseen team takes team_mu[s]
    and an unseen circuit contributes 0. `draws` is (rookie_z, noise),
    `predictive_draws(n_draws, len(drivers), seed)` when None."""
    n = len(drivers)
    if n == 0:
        return {}
    design = posterior.design
    team_of = {t: i for i, t in enumerate(design.teams)}
    driver_of = {d: i for i, d in enumerate(design.drivers)}
    circuit_i = {c: i for i, c in enumerate(design.circuits)}.get(circuit, -1)

    s_draws = posterior.n_draws
    rookie_z, noise = draws if draws is not None else predictive_draws(s_draws, n, seed)
    mu = np.zeros((s_draws, n), np.float32)
    for j, d in enumerate(drivers):
        di = driver_of.get(d, -1)
        if di >= 0:
            mu[:, j] += posterior.driver_effect[:, di]
        else:
            mu[:, j] += posterior.driver_sigma * rookie_z[:, j]
        ti = team_of.get(driver_teams.get(d) or "", -1)
        mu[:, j] += posterior.team_effect[:, ti] if ti >= 0 else posterior.team_mu
        if circuit_i >= 0:
            mu[:, j] += posterior.circuit_effect[:, circuit_i]

    gaps = mu + posterior.sigma[:, None] * noise
    return rank_draws_to_probs(gaps, drivers)


# ---------------------------------------------------------------------------
# Predictor-facing wrapper with archive-token fit caching
# ---------------------------------------------------------------------------


class BayesianQualiModel:
    """Owns one fitted posterior per feature-archive build, fitted on
    `device`.

    The fit is cached against the archive frame's loader token
    (`_mcgp_loader_token`): a walk-forward backtest rebuilds the archive per
    race (a new token refits, so race k's model sees only races < k), while
    repeated predictions within one weekend reuse the fit."""

    def __init__(
        self,
        num_chains: int = 4,
        num_warmup: int = 1000,
        num_samples: int = 1000,
        seed: int = 42,
        device: str | torch.device = "cuda",
    ):
        self.num_chains = num_chains
        self.num_warmup = num_warmup
        self.num_samples = num_samples
        self.seed = seed
        self.device = torch.device(device)
        self._token: object | None = None
        self._posterior: QualiPosterior | None = None

    def fit(self, laps: pd.DataFrame) -> QualiPosterior:
        design = build_quali_design(laps)
        posterior = sample_posterior(
            design,
            num_chains=self.num_chains,
            num_warmup=self.num_warmup,
            num_samples=self.num_samples,
            seed=self.seed,
            device=self.device,
        )
        self._posterior = posterior
        self._token = laps.attrs.get("_mcgp_loader_token")
        log_event(
            "bayes_quali_fit",
            rows=design.n_rows,
            teams=len(design.teams),
            drivers=len(design.drivers),
            circuits=len(design.circuits),
            accept=float(np.mean(posterior.accept_rate)),
            device=str(self.device),
        )
        return posterior

    def posterior_for(self, laps: pd.DataFrame) -> QualiPosterior:
        token = laps.attrs.get("_mcgp_loader_token")
        if needs_refit(self._posterior, token, self._token):
            return self.fit(laps)
        return self._posterior

    def predict(
        self,
        laps: pd.DataFrame,
        drivers: list[str],
        driver_teams: dict[str, str | None],
        circuit: str,
        seed: int = 0,
    ) -> dict[str, list[float]]:
        posterior = self.posterior_for(laps)
        return quali_position_probs(posterior, drivers, driver_teams, circuit, seed)
