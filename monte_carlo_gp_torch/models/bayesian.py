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

On a CUDA device each stage of the schedule (two warmup stages, then
sampling) is one launch of a hand-written CUDA kernel (`ops/hmc_kernel.py`,
`csrc/hmc_kernel.cu`: every transition of every chain with its momentum,
leapfrog trajectory, logp at the proposal and accept, and a warmup stage's
dual averaging and Welford variance, one block per chain, every sum in a
fixed order), the counterpart of the JAX model's compiled warmup and
sampling loops: three launches a fit. `sample_posteriors` fits one or more
designs together, each stage one launch per distinct S for all of them
(`hmc_kernel.hmc_stages`), each posterior bitwise its own fit's: a lone fit
(`sample_posterior`, `BayesianQualiModel.fit`) is a batch of one, and a
walk-forward season batches its races' fits (`BayesianQualiModel.defer` and
`fit_deferred`). On the CPU the kernel's wrapper runs the plain version the
kernel is held to: the eager stage (`hmc_kernel.stage_plain`) with the eager
transition (`sample_posterior(..., plain=True)` runs it without the wrapper
on any device).
"""

from __future__ import annotations

import dataclasses

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
from monte_carlo_gp_torch.utils.profiling import count, span

# Prior scales.
TEAM_SIGMA_SCALE = 0.5
DRIVER_SIGMA_SCALE = 0.3
CIRCUIT_SIGMA_SCALE = 0.2
OBS_SIGMA_SCALE = 0.1


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


def _staged_all(theta0s: list, stages, n_warmup: int, draws: list) -> list[tuple]:
    """The full schedule of one or more fits at once, fit i from theta0s[i]
    (chains, dim) with draws[i], each stage one `stages(thetas, eps0s,
    inv_masses, stage_draws, adapt) -> [hmc_kernel.Stage]` call for every
    fit: two warmup stages (identity mass, then the first stage's Welford
    mass), then sampling at a fixed step size and mass over the draws that
    remain after warmup. Returns each fit's (samples (samples, chains, dim),
    accept rate (chains,))."""
    w1 = max(n_warmup // 2, 1)
    w2 = max(n_warmup - w1, 1)
    stage1 = [tuple(a[:w1] for a in d) for d in draws]
    stage2 = [tuple(a[w1 : w1 + w2] for a in d) for d in draws]
    sampling = [tuple(a[w1 + w2 :] for a in d) for d in draws]
    eps0s = [torch.full((t.shape[0],), 0.1, dtype=torch.float32, device=t.device) for t in theta0s]
    first = stages(theta0s, eps0s, [torch.ones_like(t) for t in theta0s], stage1, True)
    inv_masses = [f.var for f in first]  # the optimal diagonal M^-1 is about the posterior variance
    second = stages([f.theta for f in first], [f.eps for f in first], inv_masses, stage2, True)
    last = stages([s.theta for s in second], [s.eps for s in second], inv_masses, sampling, False)
    return [(s.trace_theta, s.alpha_mean) for s in last]


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


def require_capacity(design: QualiDesign, device) -> None:
    """Refuse, before any work of its fit, a design the HMC kernel cannot
    take on `device`: on a CUDA device one over the kernel's column capacity
    (`hmc_kernel.max_cols`) raises `hmc_kernel.HMCKernelError`, as its launch
    would; the CPU's plain version takes any design."""
    dev = torch.device(device)
    if dev.type == "cuda":
        hmc_kernel.require_capacity(_param_dim(design) - _N_SCALAR, hmc_kernel.max_cols(dev),
                                    torch.cuda.get_device_name(dev))


def _plain_stages(kds: list[hmc_kernel.KernelDesign], n_leapfrog: int):
    """A `_staged_all` stages function that runs each fit's stage in turn
    as the eager `hmc_kernel.stage_plain`, every transition `_hmc_transition`
    on the fit's plain log posterior (kds[i].logp_fn, grad_fn) with
    `n_leapfrog` steps: the plain version the kernel is held to, on any
    device."""
    def stages(thetas, eps0s, inv_masses, stage_draws, adapt):
        out = []
        for kd, theta, eps0, inv_mass, draws in zip(kds, thetas, eps0s, inv_masses, stage_draws):
            def step(theta, lp, eps, inv_mass, z, u_jit, u_acc, kd=kd):
                return _hmc_transition(theta, lp, eps, inv_mass, kd.logp_fn, kd.grad_fn,
                                       n_leapfrog, z, u_jit, u_acc)

            out.append(hmc_kernel.stage_plain(theta, kd.logp_fn, step, eps0, inv_mass, draws,
                                              adapt))
        return out

    return stages


def chain_draws(seed: int, num_chains: int, dim: int, n_iters: int):
    """Every random number of a fit, from one CPU generator seeded with
    `seed`: the initial jitter (chains, dim), then per iteration the momenta
    (n_iters, chains, dim) and the step-jitter and acceptance uniforms
    (n_iters, chains) each."""
    gen = torch.Generator().manual_seed(seed)
    init = torch.randn(num_chains, dim, generator=gen)
    z = torch.randn(n_iters, num_chains, dim, generator=gen)
    u = torch.rand(n_iters, 2, num_chains, generator=gen)
    return init, (z, u[:, 0].contiguous(), u[:, 1].contiguous())


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
    there is none): `sample_posteriors` of the one design. The same seed on
    the same device gives bitwise the same `raw`. On a CUDA device each of
    the three stages is one launch of the HMC kernel (counted in
    `hmc_kernel.hmc_stage.launches`; a refusal or a failed launch raises
    `hmc_kernel.HMCKernelError`), on the CPU its plain version. `plain` runs
    the transitions eagerly without the kernel's wrapper on any device, the
    plain version the kernel is held to."""
    return sample_posteriors([design], num_chains, num_warmup, num_samples, num_leapfrog, seed,
                             device, plain=plain)[0]


def sample_posteriors(
    designs: list[QualiDesign],
    num_chains: int = 4,
    num_warmup: int = 1000,
    num_samples: int = 1000,
    num_leapfrog: int = 48,
    seed: int = 42,
    device: str | torch.device = "cuda",
    *,
    plain: bool = False,
) -> list[QualiPosterior]:
    """Fit every design at one budget and seed, all fits together: each
    stage of the schedule (`_staged_all`) is one `hmc_kernel.hmc_stages`
    call for every fit, on a CUDA device one launch of the kernel per
    distinct S of the designs (`hmc_kernel.slots`), every chain of every fit
    a block of it; on the CPU each fit's plain stages in turn. `plain` runs
    each fit's stages in turn without the kernel's wrapper on any device
    (`_plain_stages`). Each posterior is bitwise the one its design gives
    alone. A refusal of any fit raises `hmc_kernel.HMCKernelError` before
    anything launches. The sampling stage takes the draws that remain after
    warmup, `num_samples` of them.

    Several designs add their number to the counter `fit.batched`; spans
    (inside the caller's): `fit.design` per design (the log posterior and
    the kernel's statistics), one `fit.chains` (every fit's draws, their
    upload, the stage launches and the readback), then `fit.posterior` per
    design (the constrained draws)."""
    if len(designs) > 1:
        count("fit.batched", len(designs))
    dev = torch.device(device)
    kds = []
    for design in designs:
        with span("fit.design"):
            fns = make_log_posterior(design, dev)[:2]
            with torch.inference_mode():
                kds.append(kernel_design(design, dev, fns))

    def kernel_stages(thetas, eps0s, inv_masses, stage_draws, adapt):
        return hmc_kernel.hmc_stages(kds, thetas, eps0s, inv_masses, *zip(*stage_draws),
                                     int(num_leapfrog), adapt)

    stages = _plain_stages(kds, int(num_leapfrog)) if plain else kernel_stages
    with span("fit.chains"):
        with torch.inference_mode():  # no autograd bookkeeping on ~10^5 small ops
            starts = [_chain_inputs(d, num_chains, num_warmup, num_samples, seed, dev)
                      for d in designs]
            runs = _staged_all([theta0 for theta0, _ in starts], stages, int(num_warmup),
                               [draws for _, draws in starts])
            chains = [(samples.transpose(0, 1).cpu().numpy(), accept.cpu().numpy())
                      for samples, accept in runs]
    posteriors = []
    for design, kd, (raw, accept) in zip(designs, kds, chains):
        with span("fit.posterior"):
            posteriors.append(_posterior(design, kd.sizes, raw, accept))
    return posteriors


def _chain_inputs(design: QualiDesign, num_chains: int, num_warmup: int, num_samples: int,
                  seed: int, dev: torch.device):
    """(theta0 (chains, dim), the draws (z, u_jit, u_acc)) of a fit on `dev`:
    jittered inits and every iteration's draws from `chain_draws`."""
    dim = _param_dim(design)
    # Jittered inits: raws near 0, log-scales near log(prior scale / 2).
    offsets = np.zeros(dim, np.float32)
    offsets[1:_N_SCALAR] = np.log(np.asarray(_PRIOR_SCALES, np.float32) / 2)
    w1 = max(num_warmup // 2, 1)
    n_iters = w1 + max(num_warmup - w1, 1) + num_samples
    init, draws = chain_draws(seed, num_chains, dim, n_iters)
    theta0 = (torch.from_numpy(offsets) + 0.1 * init).to(dev)
    return theta0, tuple(a.to(dev) for a in draws)


def _posterior(design: QualiDesign, sizes, raw: np.ndarray, accept: np.ndarray) -> QualiPosterior:
    """The `QualiPosterior` of the draws `raw` (chains, samples, dim)."""
    chains, samples, dim = raw.shape
    con = constrain(torch.from_numpy(raw.reshape(chains * samples, dim)), sizes)
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


@dataclasses.dataclass(eq=False)
class DeferredFit:
    """A fit of `design` (the archive whose loader token is `token`) that
    `BayesianQualiModel.fit_deferred` runs with the others deferred beside
    it; `posterior` is None until then."""

    design: QualiDesign
    token: object
    posterior: QualiPosterior | None = None


class BayesianQualiModel:
    """Owns one fitted posterior per feature-archive build, fitted on
    `device`.

    The fit is cached against the archive frame's loader token
    (`_mcgp_loader_token`): a walk-forward backtest rebuilds the archive per
    race (a new token refits, so race k's model sees only races < k), while
    repeated predictions within one weekend reuse the fit.

    A walk-forward may defer its races' fits (`defer`) and run them all at
    once (`fit_deferred`), the same fits with the same cache decisions as
    `posterior_for` would take race by race, and the same posterior cached
    after them."""

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
        self._deferred: list[DeferredFit] = []

    def fit(self, laps: pd.DataFrame) -> QualiPosterior:
        """The posterior of the archive `laps` (the span `fit`, the
        archive's design frame its own time, `sample_posterior`'s spans
        inside it). A design the kernel cannot take raises before the fit
        (`require_capacity`)."""
        with span("fit"):
            design = build_quali_design(laps)
            require_capacity(design, self.device)
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
        self._log_fit(posterior)
        return posterior

    def defer(self, laps: pd.DataFrame) -> DeferredFit:
        """The fit whose posterior `posterior_for(laps)` would give at this
        point of a walk-forward, left for `fit_deferred`: the last deferred
        fit, or the cached posterior, where the archive build is the same
        (`needs_refit`), else a new deferred fit of the archive's design.
        A ValueError of the design (the archive cannot support a fit), or
        the kernel's refusal of it (`require_capacity`), propagates, and
        nothing is deferred: the fit fails here, alone, as `fit` would."""
        token = laps.attrs.get("_mcgp_loader_token")
        if self._deferred:
            last = self._deferred[-1]
            if not needs_refit(last, token, last.token):
                return last
        elif not needs_refit(self._posterior, token, self._token):
            return DeferredFit(self._posterior.design, token, self._posterior)
        design = build_quali_design(laps)
        require_capacity(design, self.device)
        fit = DeferredFit(design, token)
        self._deferred.append(fit)
        return fit

    def fit_deferred(self) -> None:
        """Run every deferred fit together (`sample_posteriors`: on a CUDA
        device one launch per stage and distinct S for all of them) in the
        span `fit`, and cache the last one's posterior, as fitting them in
        turn would leave it. A failure raises, and leaves nothing deferred
        and the cached posterior as it was."""
        deferred, self._deferred = self._deferred, []
        if not deferred:
            return
        with span("fit"):
            posteriors = sample_posteriors(
                [f.design for f in deferred],
                num_chains=self.num_chains,
                num_warmup=self.num_warmup,
                num_samples=self.num_samples,
                seed=self.seed,
                device=self.device,
            )
        for fit, posterior in zip(deferred, posteriors):
            fit.posterior = posterior
            self._log_fit(posterior)
        self._posterior, self._token = deferred[-1].posterior, deferred[-1].token

    def _log_fit(self, posterior: QualiPosterior) -> None:
        design = posterior.design
        log_event(
            "bayes_quali_fit",
            rows=design.n_rows,
            teams=len(design.teams),
            drivers=len(design.drivers),
            circuits=len(design.circuits),
            accept=float(np.mean(posterior.accept_rate)),
            device=str(self.device),
        )

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
