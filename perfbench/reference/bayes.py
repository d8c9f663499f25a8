"""The plain Bayesian qualifying model: the design of an archive and the
grid from a posterior as the port has them (frozen copies of
`monte_carlo_gp_torch/models/bayesian.py`'s `build_quali_design` and
`quali_position_probs`), and an HMC fit of the same model and schedule
written out plainly in float64.

The model (the port's docstrings): a gap y = team effect + driver effect +
circuit effect + Normal(0, sigma) per qualifying lap, non-centred, with
HalfNormal priors on the four scales. The fit: 4 chains from the port's
seeded jitter and draws, two warmup stages of dual averaging (the second at
the first's Welford mass), then sampling at a fixed step size and mass; 48
leapfrog steps a transition with a step jitter in [0.8, 1.2).

The log posterior is taken from the design's statistics (C = AᵀA, b = Aᵀy,
yᵀy, n of the one-hot design A), exact in float64. Every fit of a season
runs in one batch: the designs' columns are padded to the widest, and a
padded column has no momentum and no gradient, so it never moves.
`dtype=torch.bfloat16` is the control of the correctness check: the chains'
state and arithmetic in bfloat16 and the statistics in float32, the
precisions below the configuration's float32 and float64.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import pandas as pd
import torch

from perfbench.reference.quali_common import needs_refit, rank_draws_to_probs, valid_q_rows

PRIOR_SCALES = (0.5, 0.3, 0.2, 0.1)  # team, driver, circuit, observation
N_SCALAR = 5
DA_GAMMA, DA_T0, DA_KAPPA, TARGET_ACCEPT = 0.05, 10.0, 0.75, 0.8
VAR_MIN, VAR_MAX = 1e-4, 1e4


@dataclasses.dataclass(frozen=True)
class QualiDesign:
    y: np.ndarray  # (N,) float32 gap-to-fastest percent
    team_idx: np.ndarray
    driver_idx: np.ndarray
    circuit_idx: np.ndarray
    teams: tuple[str, ...]
    drivers: tuple[str, ...]
    circuits: tuple[str, ...]

    @property
    def sizes(self) -> tuple[int, int, int]:
        return len(self.teams), len(self.drivers), len(self.circuits)


def build_quali_design(laps: pd.DataFrame, session_type: str | None = "Q") -> QualiDesign:
    """Each usable lap's percentage gap to the fastest lap of its circuit,
    and its team, driver and circuit in first-appearance order."""
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


def statistics(design: QualiDesign) -> tuple[np.ndarray, np.ndarray, float, int]:
    """(C (K, K), b (K,), yᵀy, n) of the one-hot design, in float64."""
    t, d, c = design.sizes
    n = design.y.shape[0]
    a = np.zeros((n, t + d + c), np.float64)
    rows = np.arange(n)
    a[rows, design.team_idx] = 1.0
    a[rows, t + design.driver_idx] = 1.0
    a[rows, t + d + design.circuit_idx] = 1.0
    y = design.y.astype(np.float64)
    return a.T @ a, a.T @ y, float(y @ y), n


def nnz(design: QualiDesign) -> int:
    """The non-zero entries of C: the pairs of effect columns that share a
    row (the roofline's count of float64 work)."""
    return int(np.count_nonzero(statistics(design)[0]))


@dataclasses.dataclass(frozen=True)
class Posterior:
    design: QualiDesign
    team_effect: np.ndarray  # (S, T)
    driver_effect: np.ndarray  # (S, D)
    circuit_effect: np.ndarray  # (S, C)
    team_mu: np.ndarray  # (S,)
    driver_sigma: np.ndarray  # (S,)
    sigma: np.ndarray  # (S,)

    @property
    def n_draws(self) -> int:
        return int(self.sigma.shape[0])


class _Batch:
    """The log posterior of R padded designs and its gradient, for a state
    theta (R, chains, dim)."""

    def __init__(self, designs: list[QualiDesign], dtype: torch.dtype, device):
        stats_dtype = torch.float64 if dtype == torch.float64 else torch.float32
        k = max(sum(dz.sizes) for dz in designs)
        r = len(designs)
        self.dim = N_SCALAR + k
        counts = np.zeros((r, k, k))
        b = np.zeros((r, k))
        seg = np.full((r, k), 3)
        for i, dz in enumerate(designs):
            c_i, b_i, yty, n = statistics(dz)
            kk = c_i.shape[0]
            counts[i, :kk, :kk] = c_i
            b[i, :kk] = b_i
            seg[i, :kk] = np.repeat(np.arange(3), dz.sizes)
        self.counts = torch.from_numpy(counts).to(stats_dtype)
        self.b = torch.from_numpy(b).to(stats_dtype)
        self.yty = torch.tensor([float(y.astype(np.float64) @ y.astype(np.float64))
                                 for y in (dz.y for dz in designs)], dtype=stats_dtype)[:, None]
        self.n = torch.tensor([float(dz.y.shape[0]) for dz in designs], dtype=dtype)[:, None]
        onehot = np.eye(4)[seg]  # (R, K, 4): a column's scale
        self.seg = torch.from_numpy(onehot[..., :3]).to(dtype)  # (R, K, 3)
        self.team = torch.from_numpy((seg == 0).astype(np.float64)).to(dtype)[:, None, :]
        live = np.ones((r, self.dim))
        live[:, N_SCALAR:] = seg != 3
        self.live = torch.from_numpy(live).to(dtype)[:, None, :]  # (R, 1, dim)
        self.prior_prec = torch.tensor([s**-2 for s in PRIOR_SCALES], dtype=dtype)
        self.dtype, self.stats_dtype = dtype, stats_dtype
        for name in ("counts", "b", "yty", "n", "seg", "team", "live", "prior_prec"):
            setattr(self, name, getattr(self, name).to(device))

    def _parts(self, theta):
        mu = theta[..., 0:1]
        log_sig = theta[..., 1:N_SCALAR]
        raw = theta[..., N_SCALAR:]
        sig = torch.exp(log_sig)
        scale = sig[..., None, :3] @ self.seg.transpose(1, 2)[:, None]  # (R, chains, 1, K)
        scale = scale[..., 0, :]
        eff = mu * self.team + raw * scale
        e64 = eff.to(self.stats_dtype)
        c_eff = e64 @ self.counts  # C is symmetric
        sq = (c_eff * e64).sum(-1, keepdim=True) - 2.0 * (e64 * self.b[:, None]).sum(-1, keepdim=True) \
            + self.yty[:, None]
        return mu, log_sig, raw, sig, scale, eff, c_eff, sq

    def logp(self, theta):
        mu, log_sig, raw, sig, _, _, _, sq = self._parts(theta)
        inv_var = torch.exp(-2.0 * log_sig[..., 3:4])
        lp = -0.5 * mu**2 + (-0.5 * sig**2 * self.prior_prec + log_sig).sum(-1, keepdim=True)
        lp = lp - 0.5 * (raw**2).sum(-1, keepdim=True)
        lp = lp - 0.5 * sq.to(self.dtype) * inv_var - self.n[:, None] * log_sig[..., 3:4]
        return lp[..., 0]

    def grad(self, theta):
        mu, log_sig, raw, sig, scale, _, c_eff, sq = self._parts(theta)
        inv_var = torch.exp(-2.0 * log_sig[..., 3:4])
        g_eff = -(c_eff - self.b[:, None]).to(self.dtype) * inv_var
        g_mu = (g_eff * self.team).sum(-1, keepdim=True) - mu
        g_sig = 1.0 - sig**2 * self.prior_prec
        per_scale = (g_eff * raw)[..., None, :] @ self.seg[:, None]  # (R, chains, 1, 3)
        g_sig = torch.cat([g_sig[..., :3] + sig[..., :3] * per_scale[..., 0, :],
                           g_sig[..., 3:4] + sq.to(self.dtype) * inv_var - self.n[:, None]], -1)
        g_raw = -raw + scale * g_eff
        return torch.cat([g_mu, g_sig, g_raw], -1) * self.live


def _transition(batch: _Batch, theta, lp, eps, inv_mass, z, u_jit, u_acc, n_leapfrog: int):
    p = z * batch.live / torch.sqrt(inv_mass)
    eps = (eps * (0.8 + 0.4 * u_jit))[..., None]
    half, drift = 0.5 * eps, eps * inv_mass
    th = theta
    q = p + half * batch.grad(th)
    for _ in range(n_leapfrog - 1):
        th = th + drift * q
        q = q + eps * batch.grad(th)
    th = th + drift * q
    q = q + half * batch.grad(th)
    lp_new = batch.logp(th)
    ke = 0.5 * (p * inv_mass * p).sum(-1)
    ke_new = 0.5 * (q * inv_mass * q).sum(-1)
    log_alpha = (lp_new - ke_new) - (lp - ke)
    alpha = torch.where(torch.isfinite(log_alpha), torch.exp(log_alpha).clamp(max=1.0),
                        torch.zeros_like(log_alpha))
    accept = u_acc < alpha
    return torch.where(accept[..., None], th, theta), torch.where(accept, lp_new, lp), alpha


class _GraphedStep:
    """`_transition` replayed from one captured CUDA graph: the same
    PyTorch operations, launched together, since a fit is some 10^5 tiny
    dependent steps."""

    def __init__(self, batch: _Batch, n_leapfrog: int, like: torch.Tensor):
        r, chains, _ = like.shape
        self.inputs = [torch.zeros_like(like), torch.zeros((r, chains), dtype=like.dtype,
                                                            device=like.device)]
        self.inputs += [torch.ones((r, chains), dtype=like.dtype, device=like.device),
                        torch.ones_like(like), torch.zeros_like(like)]
        self.inputs += [torch.zeros((r, chains), dtype=like.dtype, device=like.device)
                        for _ in range(2)]
        step = functools.partial(_transition, batch, n_leapfrog=n_leapfrog)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(2):  # warm the allocator and the libraries
                step(*self.inputs)
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = step(*self.inputs)

    def __call__(self, *args):
        for buf, value in zip(self.inputs, args):
            buf.copy_(value)
        self.graph.replay()
        return tuple(o.clone() for o in self.outputs)


def _stage(batch, step, theta, eps0, inv_mass, draws, adapt):
    """One stage: (theta, eps, var or None, the draws of every iteration)."""
    z, u_jit, u_acc = draws
    n_iters = z.shape[0]
    lp = batch.logp(theta)
    mu = math.log(10.0) + torch.log(eps0)
    h_bar = torch.zeros_like(eps0)
    log_eps = log_eps_bar = torch.log(eps0)
    w_n, w_mean, w_m2 = 0, torch.zeros_like(theta), torch.zeros_like(theta)
    trace = torch.empty((n_iters, *theta.shape), dtype=theta.dtype, device=theta.device)
    for it in range(n_iters):
        eps = torch.exp(log_eps) if adapt else eps0
        theta, lp, alpha = step(theta, lp, eps, inv_mass, z[it], u_jit[it], u_acc[it])
        trace[it] = theta
        if adapt:
            m = it + 1.0
            h_bar = (1.0 - 1.0 / (m + DA_T0)) * h_bar + (TARGET_ACCEPT - alpha) / (m + DA_T0)
            log_eps = mu - math.sqrt(m) / DA_GAMMA * h_bar
            w = m ** (-DA_KAPPA)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            if it >= n_iters // 2:
                w_n += 1
                delta = theta - w_mean
                w_mean = w_mean + delta / w_n
                w_m2 = w_m2 + delta * (theta - w_mean)
    if not adapt:
        return theta, eps0, None, trace
    var = w_m2 / (w_n - 1) if w_n > 1 else torch.ones_like(w_m2)
    return theta, torch.exp(log_eps_bar), var.clamp(VAR_MIN, VAR_MAX), trace


def _chain_draws(seed: int, chains: int, dim: int, n_iters: int):
    """The port's draws of a fit (`chain_draws`): one CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    init = torch.randn(chains, dim, generator=gen)
    z = torch.randn(n_iters, chains, dim, generator=gen)
    u = torch.rand(n_iters, 2, chains, generator=gen)
    return init, z, u[:, 0], u[:, 1]


def fit_batch(designs: list[QualiDesign], chains: int = 4, warmup: int = 1000,
              samples: int = 1000, n_leapfrog: int = 48, seed: int = 42,
              dtype: torch.dtype = torch.float64, device="cpu") -> list[Posterior]:
    """The posterior of each design, every fit in one batch on `device`."""
    dev = torch.device(device)
    batch = _Batch(designs, dtype, dev)
    w1 = max(warmup // 2, 1)
    w2 = max(warmup - w1, 1)
    n_iters = w1 + w2 + samples
    r, dim = len(designs), batch.dim
    theta0 = torch.zeros((r, chains, dim), dtype=dtype)
    z = torch.zeros((n_iters, r, chains, dim), dtype=dtype)
    u_jit = torch.zeros((n_iters, r, chains), dtype=dtype)
    u_acc = torch.zeros((n_iters, r, chains), dtype=dtype)
    offsets = torch.zeros(dim)
    offsets[1:N_SCALAR] = torch.log(torch.tensor(PRIOR_SCALES) / 2)
    for i, dz in enumerate(designs):
        di = N_SCALAR + sum(dz.sizes)
        init, zi, uj, ua = _chain_draws(seed, chains, di, n_iters)
        theta0[i, :, :di] = (offsets[:di] + 0.1 * init).to(dtype)
        z[:, i, :, :di] = zi.to(dtype)
        u_jit[:, i], u_acc[:, i] = uj.to(dtype), ua.to(dtype)
    theta0 = theta0.to(dev) * batch.live
    z, u_jit, u_acc = z.to(dev), u_jit.to(dev), u_acc.to(dev)
    eps0 = torch.full((r, chains), 0.1, dtype=dtype, device=dev)
    cut = (slice(0, w1), slice(w1, w1 + w2), slice(w1 + w2, n_iters))
    draws = [tuple(a[s] for a in (z, u_jit, u_acc)) for s in cut]
    with torch.inference_mode():
        if dev.type == "cuda":
            step = _GraphedStep(batch, n_leapfrog, theta0)
        else:
            step = functools.partial(_transition, batch, n_leapfrog=n_leapfrog)
        theta, eps, inv_mass, _ = _stage(batch, step, theta0, eps0, torch.ones_like(theta0),
                                         draws[0], True)
        theta, eps, _, _ = _stage(batch, step, theta, eps, inv_mass, draws[1], True)
        _, _, _, trace = _stage(batch, step, theta, eps, inv_mass, draws[2], False)
        raw = trace.to(torch.float32).permute(1, 2, 0, 3).cpu().numpy()  # (R, chains, samples, dim)
    del step
    out = []
    for i, dz in enumerate(designs):
        t, d, c = dz.sizes
        th = raw[i].reshape(chains * samples, -1)
        sig = np.exp(th[:, 1:N_SCALAR])
        mu = th[:, 0]
        out.append(Posterior(
            design=dz,
            team_effect=mu[:, None] + sig[:, 0:1] * th[:, N_SCALAR:N_SCALAR + t],
            driver_effect=sig[:, 1:2] * th[:, N_SCALAR + t:N_SCALAR + t + d],
            circuit_effect=sig[:, 2:3] * th[:, N_SCALAR + t + d:N_SCALAR + t + d + c],
            team_mu=mu, driver_sigma=sig[:, 1], sigma=sig[:, 3],
        ))
    return out


def quali_position_probs(posterior: Posterior, drivers: list[str],
                         driver_teams: dict[str, str | None], circuit: str,
                         seed: int) -> dict[str, list[float]]:
    """The posterior-predictive grid of a field (the port's
    `quali_position_probs` with its `predictive_draws`)."""
    n = len(drivers)
    if n == 0:
        return {}
    design = posterior.design
    team_of = {t: i for i, t in enumerate(design.teams)}
    driver_of = {d: i for i, d in enumerate(design.drivers)}
    circuit_i = {c: i for i, c in enumerate(design.circuits)}.get(circuit, -1)
    s_draws = posterior.n_draws
    gen = torch.Generator().manual_seed(seed)
    rookie_z = torch.randn(s_draws, n, generator=gen).numpy()
    noise = torch.randn(s_draws, n, generator=gen).numpy()
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


@dataclasses.dataclass
class _Pending:
    fit: int  # index into the designs
    drivers: list[str]
    teams: dict[str, str | None]
    circuit: str
    seed: int


class DeferredBayes:
    """The reference predictor's Bayesian model: `predict` records the
    archive's design (a new one only when the loader rebuilt the archive, as
    the port's fit cache decides) and the field, and hands back a uniform
    placeholder grid; `resolve` then fits every design in one batch and
    gives each recorded request its grid, in order."""

    def __init__(self):
        self.designs: list[QualiDesign] = []
        self.pending: list[_Pending] = []
        self._token = None

    def predict(self, laps, drivers, driver_teams, circuit, seed=0):
        token = laps.attrs.get("_mcgp_loader_token")
        if needs_refit(self.designs[-1] if self.designs else None, token, self._token):
            self.designs.append(build_quali_design(laps))
            self._token = token
        self.pending.append(_Pending(len(self.designs) - 1, list(drivers), dict(driver_teams),
                                     circuit, seed))
        n = len(drivers)
        return {d: [1.0 / n] * n for d in drivers}

    def resolve(self, fit: dict, dtype: torch.dtype = torch.float64,
                device="cpu") -> list[dict[str, list[float]]]:
        """The grid of each recorded request, every design fitted in one
        batch on `device` at the budget `fit` (the configuration's `fit`:
        chains, warmup, samples, leapfrog, seed)."""
        budget = dict(chains=fit["chains"], warmup=fit["warmup"], samples=fit["samples"],
                      n_leapfrog=fit["leapfrog"], seed=fit["seed"])
        posts = fit_batch(self.designs, dtype=dtype, device=device, **budget) \
            if self.designs else []
        return [quali_position_probs(posts[p.fit], p.drivers, p.teams, p.circuit, p.seed)
                for p in self.pending]

