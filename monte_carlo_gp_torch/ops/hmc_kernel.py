"""The Bayesian qualifying model's HMC sampler on the card (`csrc/hmc_kernel.cu`),
the counterpart of the JAX fit's compiled warmup and sampling loops
(`monte_carlo_gp_tpu/models/bayesian.py:247-360`: `_leapfrog`,
`_hmc_transition`, `_warmup_scan`, `_sample_chain`, which XLA computes; no
Pallas kernel).

`hmc_stages` runs every transition of one stage of one or more fits for
every chain: a warmup stage (dual-averaged step sizes at a fixed mass, a
Welford variance over its second half) or the sampling stage (a fixed step
size and mass). It returns a `Stage` per fit: the chains' final state, the
stage's adapted step size and variance, and its per-iteration trace (theta
after each transition, lp, the step size used and alpha); `hmc_stage` is
`hmc_stages` of one fit. `hmc_transition` is one transition from given
inputs (theta, lp, eps, inv_mass, z, u_jit, u_acc) -> (theta', lp', alpha);
`hmc_logp` is logp (and the gradient) at theta. For CPU tensors each runs its
plain version: `stage_plain` with `hmc_transition_plain` steps (the eager
schedule of `models/bayesian.py`'s fit) and `make_log_posterior`'s functions.
For CUDA tensors each launches the kernel through its one C entry, or
raises: every launch takes a table of fits (`launch_tables`), one row per fit
of one S (the parameters a lane holds, `slots`), a block per chain of every
fit, each block on its own fit's design and inputs, so each fit's `Stage` is
bitwise what it gives alone; one fit's chains fill only 4 of an H100's 132
SMs. A lone fit, the one-transition entry and the logp entry are tables of
one. Each counts its launches (`hmc_stage.launches` for the stages of every
fit, `hmc_transition.launches`, `hmc_logp.launches`).

The model is linear-Gaussian in its effects: every training row has exactly
one team, one driver and one circuit column, so with A the (N, K) one-hot
design and err = A·eff - y, the effects' gradient A^T·err = C·eff - b and
sum(err^2) = eff·(C·eff - b) - b·eff + y^T·y, with C = A^T·A (K x K integer
co-occurrence counts), b = A^T·y. `KernelDesign` carries (C, b, y^T·y, n),
built once per fit on the host in float64, and the kernel never reads a row:
each gradient is a K x K product in float64 (why float64: near the
posterior C·eff and b agree to within the column sums, ~10 against ~10^3,
so float32 rounding would swamp the gradient). C lives in the block's shared
memory and the chain's state in one warp's registers, which bound the
effect columns a launch takes (`max_cols`, 167 on an H100); a design over it
raises `HMCKernelError` naming the capacity and is never cut. The number of
rows bounds nothing. Every refusal of the wrapper, and a failed launch,
raises `HMCKernelError`. `stats_log_posterior` computes logp and the
gradient in plain PyTorch from the same statistics in the kernel's order of
operations; the tests hold it to `make_log_posterior` on the CPU, and to the
kernel on the card. What bounds the kernel is the latency of its 49
dependent K x K products a transition, not a pass over data; the source
note in `csrc/hmc_kernel.cu` says what its design does about it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import re
from typing import Callable

import numpy as np
import torch

# warps per block, one block per chain (csrc/hmc_kernel.cu: kWarps): warp w
# sums range w of the product
WARPS = 4
# the K x K product's fixed order: each effect's sum in RANGES contiguous
# ranges of the columns, each summed in column order, then the ranges in order
RANGES = 4
# the parameters a lane of warp 0 keeps in registers: lane L holds
# parameters L, L + 32, ..., so theta takes at most 32 x SLOTS entries
SLOTS = 6
_N_SCALAR = 5  # team_mu and the four log-scales lead theta
_SOURCES = ["hmc_kernel.cu"]
_lib = None

# Dual-averaging constants (Hoffman & Gelman 2014, table 1).
DA_GAMMA = 0.05
DA_T0 = 10.0
DA_KAPPA = 0.75
TARGET_ACCEPT = 0.8
# the Welford variance's clamp, the next stage's and the sampler's mass
VAR_MIN, VAR_MAX = 1e-4, 1e4


class HMCKernelError(RuntimeError):
    """The HMC kernel's wrapper refused a call (its inputs, or a design over
    the kernel's column capacity), or the launch failed. Not a ValueError:
    the predictor reads a ValueError from a fit as "the archive cannot
    support a fit" and takes the Elo grid instead, and a refused kernel must
    fail the weekend."""


# ---------------------------------------------------------------------------
# The plain version: the eager transition and stage
# ---------------------------------------------------------------------------


def leapfrog(theta, p, eps, inv_mass, grad_fn, n_steps: int):
    """`n_steps` leapfrog steps of every chain: theta, p and inv_mass are
    (chains, dim), eps is (chains,)."""
    eps = eps[:, None]
    half, drift = 0.5 * eps, eps * inv_mass
    p = p + half * grad_fn(theta)
    for _ in range(n_steps - 1):
        theta = theta + drift * p
        p = p + eps * grad_fn(theta)
    theta = theta + drift * p
    p = p + half * grad_fn(theta)
    return theta, p


def hmc_transition_plain(theta, lp, eps, inv_mass, logp_fn, grad_fn, n_leapfrog, z, u_jit, u_acc):
    """One Metropolis-corrected HMC proposal per chain from the standard
    normals `z` (chains, dim) and the uniforms `u_jit`, `u_acc` (chains,).
    Returns (theta', lp', alpha), alpha being the acceptance probability
    that dual averaging reads."""
    p = z / torch.sqrt(inv_mass)  # p ~ N(0, M), M = 1 / inv_mass (diagonal)
    # A multiplicative step jitter in [0.8, 1.2) breaks leapfrog periodicity
    # (a fixed (eps, L) can resonate with a mode's curvature and trap a chain
    # at low acceptance); dual averaging still sees the realized alpha.
    eps = eps * (0.8 + 0.4 * u_jit)
    theta_new, p_new = leapfrog(theta, p, eps, inv_mass, grad_fn, n_leapfrog)
    lp_new = logp_fn(theta_new)
    ke = 0.5 * torch.sum(p * inv_mass * p, dim=1)
    ke_new = 0.5 * torch.sum(p_new * inv_mass * p_new, dim=1)
    log_alpha = (lp_new - ke_new) - (lp - ke)
    alpha = torch.where(torch.isfinite(log_alpha), torch.exp(log_alpha).clamp(max=1.0), 0.0)
    accept = u_acc < alpha
    theta = torch.where(accept[:, None], theta_new, theta)
    lp = torch.where(accept, lp_new, lp)
    return theta, lp, alpha


class Adaptation:
    """One warmup stage's adaptation of every chain, float32 on theta's
    device: the step size dual-averaged towards TARGET_ACCEPT, and a Welford
    variance of the draws over the stage's second half. The kernel computes
    the same per chain inside its stage launch, these Python scalars in
    double rounded to float32."""

    def __init__(self, theta, eps0, n_iters: int):
        self.half = n_iters // 2
        self.mu = math.log(10.0) + torch.log(eps0)
        self.h_bar = torch.zeros_like(eps0)
        self.log_eps = torch.log(eps0)
        self.log_eps_bar = self.log_eps
        self.w_n = 0
        self.w_mean = torch.zeros_like(theta)
        self.w_m2 = torch.zeros_like(theta)

    def eps(self) -> torch.Tensor:
        """The step size of the next transition."""
        return torch.exp(self.log_eps)

    def update(self, it: int, theta, alpha) -> None:
        """After transition `it` (0-based) reached `theta` with `alpha`."""
        m = it + 1.0
        self.h_bar = (1.0 - 1.0 / (m + DA_T0)) * self.h_bar + (TARGET_ACCEPT - alpha) / (m + DA_T0)
        self.log_eps = self.mu - math.sqrt(m) / DA_GAMMA * self.h_bar
        w = m ** (-DA_KAPPA)
        self.log_eps_bar = w * self.log_eps + (1.0 - w) * self.log_eps_bar
        if it >= self.half:  # Welford over the stage's second half
            self.w_n += 1
            delta = theta - self.w_mean
            self.w_mean = self.w_mean + delta / self.w_n
            self.w_m2 = self.w_m2 + delta * (theta - self.w_mean)

    def result(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(the adapted step size (chains,), the clamped variance (chains,
        dim))."""
        var = self.w_m2 / (self.w_n - 1) if self.w_n > 1 else torch.ones_like(self.w_m2)
        return torch.exp(self.log_eps_bar), var.clamp(VAR_MIN, VAR_MAX)


@dataclasses.dataclass(frozen=True)
class Stage:
    """What one stage returns: every chain's final theta (chains, dim) and
    lp (chains,); `eps`, the adapted step size (a warmup stage) or the one it
    ran at (sampling); `var`, the Welford variance (chains, dim) of a warmup
    stage, else None; `alpha_mean` (chains,); `lp0`, logp at the stage's
    start; and the trace, per iteration: theta after the transition
    (iters, chains, dim), lp, the step size used and alpha (iters, chains)."""

    theta: torch.Tensor
    lp: torch.Tensor
    eps: torch.Tensor
    var: torch.Tensor | None
    alpha_mean: torch.Tensor
    lp0: torch.Tensor
    trace_theta: torch.Tensor
    trace_lp: torch.Tensor
    trace_eps: torch.Tensor
    trace_alpha: torch.Tensor


def stage_plain(theta, logp_fn, step, eps0, inv_mass, draws, adapt: bool) -> Stage:
    """One stage over len(draws[0]) iterations, each a `step(theta, lp, eps,
    inv_mass, z, u_jit, u_acc) -> (theta, lp, alpha)`, from logp at theta:
    with `adapt`, each chain's step size dual-averaged from `eps0` at a fixed
    `inv_mass` and a Welford variance of its draws over the stage's second
    half (the next stage's and the sampler's diagonal mass); without, every
    transition at `eps0`."""
    z, u_jit, u_acc = draws
    n_iters = z.shape[0]
    lp = lp0 = logp_fn(theta)
    adaptation = Adaptation(theta, eps0, n_iters) if adapt else None
    trace_theta = torch.empty((n_iters, *theta.shape), dtype=theta.dtype, device=theta.device)
    trace_lp, trace_eps, trace_alpha = (torch.empty((n_iters, *eps0.shape), dtype=eps0.dtype,
                                                    device=eps0.device) for _ in range(3))
    alpha_sum = torch.zeros_like(eps0)
    for it in range(n_iters):
        eps = adaptation.eps() if adapt else eps0
        theta, lp, alpha = step(theta, lp, eps, inv_mass, z[it], u_jit[it], u_acc[it])
        trace_theta[it], trace_lp[it], trace_eps[it], trace_alpha[it] = theta, lp, eps, alpha
        alpha_sum = alpha_sum + alpha
        if adapt:
            adaptation.update(it, theta, alpha)
    eps, var = adaptation.result() if adapt else (eps0, None)
    return Stage(theta, lp, eps, var, alpha_sum / n_iters, lp0, trace_theta, trace_lp, trace_eps,
                 trace_alpha)


def replay_adaptation(eps0, trace_theta, trace_alpha) -> dict:
    """A warmup stage's adaptation replayed from its trace: `Adaptation`
    from `eps0` fed each iteration's theta and alpha. Returns {"eps": the
    step size of each iteration (iters, chains), "final_eps", "var",
    "alpha_mean"}, what the stage's trace and result hold."""
    n_iters = trace_alpha.shape[0]
    adaptation = Adaptation(trace_theta[0], eps0, n_iters)
    eps = torch.empty_like(trace_alpha)
    alpha_sum = torch.zeros_like(eps0)
    for it in range(n_iters):
        eps[it] = adaptation.eps()
        alpha_sum = alpha_sum + trace_alpha[it]
        adaptation.update(it, trace_theta[it], trace_alpha[it])
    final_eps, var = adaptation.result()
    return {"eps": eps, "final_eps": final_eps, "var": var, "alpha_mean": alpha_sum / n_iters}


# ---------------------------------------------------------------------------
# The design as the kernel reads it: its sufficient statistics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelDesign:
    """The training rows of one fit as the kernel reads them, on one device,
    with the plain version's log posterior on the same device.

    `counts` (K, K) float64 is C = A^T·A of the one-hot design A, whose
    columns are the T team, D driver and C circuit effects; `b` (K,) float64
    is A^T·y; `yty` is y^T·y and `n_rows` the number of rows. `prior_prec`
    are the float32 values 1 / scale² of the four prior scales; `logp_fn`
    and `grad_fn` are `make_log_posterior`'s."""

    counts: torch.Tensor
    b: torch.Tensor
    yty: float
    n_rows: int
    sizes: tuple[int, int, int]
    prior_prec: tuple[float, float, float, float]
    logp_fn: Callable
    grad_fn: Callable

    @property
    def n_cols(self) -> int:
        return sum(self.sizes)

    @property
    def dim(self) -> int:
        return _N_SCALAR + self.n_cols

    @property
    def device(self) -> torch.device:
        return self.counts.device


def one_hot_design(team_idx, driver_idx, circuit_idx, sizes) -> np.ndarray:
    """A, the (N, K) float64 one-hot design: row i has a 1 in its team's
    column t_i, its driver's T + d_i and its circuit's T + D + c_i."""
    t, d, c = sizes
    parts = [np.asarray(a, np.int64) for a in (team_idx, driver_idx, circuit_idx)]
    for name, idx, size in zip(("team", "driver", "circuit"), parts, sizes):
        if idx.size and (idx.min() < 0 or idx.max() >= size):
            raise HMCKernelError(f"{name} indices must lie in [0, {size})")
    n = parts[0].shape[0]
    a = np.zeros((n, t + d + c), np.float64)
    rows = np.arange(n)
    for offset, idx in zip((0, t, t + d), parts):
        a[rows, offset + idx] = 1.0
    return a


def design_statistics(y, team_idx, driver_idx, circuit_idx,
                      sizes) -> tuple[np.ndarray, np.ndarray, float, int]:
    """(C = A^T·A (K, K), b = A^T·y (K,), y^T·y, n) in float64 for the
    float32 targets y. Every entry of C is an integer count (exact), so each
    product of a count and a float32 effect is exact in float64."""
    a = one_hot_design(team_idx, driver_idx, circuit_idx, sizes)
    y64 = np.asarray(y, np.float32).astype(np.float64)
    return a.T @ a, a.T @ y64, float(y64 @ y64), int(y64.shape[0])


def kernel_design(y, team_idx, driver_idx, circuit_idx, sizes, prior_scales, logp_fn, grad_fn,
                  device) -> KernelDesign:
    """The `KernelDesign` of the rows (y, team_idx, driver_idx, circuit_idx)
    with (T, D, C) = `sizes` on `device`; `logp_fn` and `grad_fn` are the plain
    log posterior of the same rows on the same device."""
    counts, b, yty, n = design_statistics(y, team_idx, driver_idx, circuit_idx, sizes)
    dev = torch.device(device)
    return KernelDesign(
        counts=torch.from_numpy(np.ascontiguousarray(counts)).to(dev),
        b=torch.from_numpy(b).to(dev),
        yty=yty,
        n_rows=n,
        sizes=tuple(int(s) for s in sizes),
        prior_prec=tuple(float(np.float32(s**-2)) for s in prior_scales),
        logp_fn=logp_fn,
        grad_fn=grad_fn,
    )


# ---------------------------------------------------------------------------
# The kernel's arithmetic in plain PyTorch (for the tests)
# ---------------------------------------------------------------------------


def _xor_tree(v: torch.Tensor) -> torch.Tensor:
    """The kernel's `warp_sum` over the last axis (32 lanes): lane 0's sum."""
    lanes = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v[..., 0]


def _strided_sum(v: torch.Tensor, stride: int) -> torch.Tensor:
    """(..., stride) partials: element j of the last axis added to partial
    j % stride, in order of j, as a thread or lane strided by `stride` adds."""
    n = v.shape[-1]
    pad = -n % stride
    v = torch.nn.functional.pad(v, (0, pad)).reshape(*v.shape[:-1], -1, stride)
    acc = torch.zeros_like(v[..., 0, :])
    for m in range(v.shape[-2]):
        acc = acc + v[..., m, :]
    return acc


def _lane_sum(v: torch.Tensor) -> torch.Tensor:
    """One warp's sum over the last axis: lane-strided partials, then the
    butterfly."""
    return _xor_tree(_strided_sum(v, 32))


def _effect_sum(v: torch.Tensor) -> torch.Tensor:
    """The kernel's sum over the effects (last axis): effect k is parameter
    5 + k, which lane (5 + k) % 32 adds in order of k, then the butterfly."""
    return _lane_sum(torch.nn.functional.pad(v, (_N_SCALAR, 0)))


def stats_log_posterior(kd: KernelDesign, theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(logp (chains,), gradient (chains, dim)) of `theta` (chains, dim)
    computed from kd's statistics in the kernel's order of operations: the
    effects in float32; colsum = C·eff - b in float64, each effect's sum over
    RANGES contiguous column ranges, each in column order, then the ranges in
    order; sum(err^2) = sum_k eff_k·(colsum_k - b_k) + y^T·y in float64, each
    sum over the effects taken as the kernel's lanes take it (effect k in
    lane (5 + k) % 32, in order), then a butterfly; then, from colsum and
    sum(err^2) rounded to float32, the gradient and logp in float32 as the
    kernel takes them."""
    k = kd.n_cols
    counts, b = kd.counts.to(theta.device), kd.b.to(theta.device)
    team_mu, log_sig, raw = theta[:, 0], theta[:, 1:_N_SCALAR], theta[:, _N_SCALAR:]
    sig = torch.exp(log_sig)
    inv_var = torch.exp(-2.0 * log_sig[:, 3])
    seg = torch.cat([torch.full((n,), j, dtype=torch.long, device=theta.device)
                     for j, n in enumerate(kd.sizes)])
    scale = sig[:, seg]
    mask = (seg == 0).to(theta.dtype)
    eff = team_mu[:, None] * mask + raw * scale
    effd = eff.double()
    width = -(-k // RANGES)
    parts = []
    for q in range(RANGES):
        acc = torch.zeros_like(effd)
        for j in range(q * width, min((q + 1) * width, k)):
            acc = acc + counts[:, j] * effd[:, j:j + 1]  # C is symmetric: row j
        parts.append(acc)
    colsum = parts[0] + parts[1]
    for part in parts[2:]:
        colsum = colsum + part
    colsum = colsum - b
    sq = (_effect_sum(effd * (colsum - b)) + kd.yty).float()
    colsum = colsum.float()

    g_eff = colsum * -inv_var[:, None]
    zero = torch.zeros_like(g_eff)
    team = _effect_sum(torch.where(seg == 0, g_eff, zero))
    gr = g_eff * raw
    seg_sums = [_effect_sum(torch.where(seg == j, gr, zero)) for j in range(3)]
    g_raw = -raw + scale * g_eff
    g_obs = sq * inv_var - float(kd.n_rows)
    prec = kd.prior_prec
    g_sig = []
    for j in range(4):
        v = 1.0 - (sig[:, j] * sig[:, j]) * prec[j]
        v = v + sig[:, j] * (seg_sums[j] if j < 3 else torch.zeros_like(sq))
        g_sig.append(v + g_obs * (1.0 if j == 3 else 0.0))
    grad = torch.cat([(team - team_mu)[:, None], torch.stack(g_sig, 1), g_raw], dim=1)

    raw2 = _effect_sum(raw * raw)
    prior = (-0.5 * (sig[:, 0] * sig[:, 0])) * prec[0] + log_sig[:, 0]
    for j in (1, 2, 3):
        prior = prior + ((-0.5 * (sig[:, j] * sig[:, j])) * prec[j] + log_sig[:, j])
    lp = -0.5 * (team_mu * team_mu)
    lp = lp + prior
    lp = lp - 0.5 * raw2
    lp = lp - (0.5 * sq) * inv_var
    return lp - float(kd.n_rows) * log_sig[:, 3], grad


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


def is_built() -> bool:
    """Whether the CUDA library of the current sources is already built."""
    from monte_carlo_gp_torch.ops._build import library_path

    return library_path("hmc_kernel", _SOURCES).exists()


def build():
    """Build (or find) the CUDA library and load it; returns its path."""
    global _lib
    from monte_carlo_gp_torch.ops._build import build_cuda_library

    path = build_cuda_library("hmc_kernel", _SOURCES)
    if _lib is None:
        _lib = load_library(path)
    return path


def load_library(path) -> ctypes.CDLL:
    """A built HMC-kernel library with its C entry points' signatures set."""
    lib = ctypes.CDLL(str(path))
    p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    lib.mcgp_hmc_run.argtypes = [i, p, p, p, p, i, d, d, d, f, f, f, f, i, i, p, p]
    lib.mcgp_hmc_run.restype = i
    lib.mcgp_hmc_args_bytes.argtypes = []
    lib.mcgp_hmc_args_bytes.restype = i
    lib.mcgp_hmc_max_shared_bytes.argtypes = []
    lib.mcgp_hmc_max_shared_bytes.restype = i
    lib.mcgp_hmc_blocks_per_sm.argtypes = [i]
    lib.mcgp_hmc_blocks_per_sm.restype = i
    return lib


def shared_bytes(n_cols: int) -> int:
    """Dynamic shared memory of one block (one chain) at `n_cols` effect
    columns (csrc/hmc_kernel.cu: shared_bytes), float64: C padded with zero
    rows to kp = RANGES * ceil(K / RANGES), the effects (kp) and the RANGES
    range sums per effect. The chain's state lives in registers."""
    k = n_cols
    kp = -(-k // RANGES) * RANGES
    return 8 * (kp * k + kp + RANGES * k)


@functools.lru_cache(maxsize=None)
def _max_shared_bytes(device_index: int) -> int:
    with torch.cuda.device(device_index):
        n = _lib.mcgp_hmc_max_shared_bytes()
    if n < 0:
        raise HMCKernelError("the shared-memory query of the HMC kernel failed")
    return n


def capacity_for(shared: int) -> int:
    """The most effect columns whose block fits in `shared` bytes and whose
    parameters fit in warp 0's registers (5 + K <= 32 x SLOTS)."""
    k = min(int(math.isqrt(max(shared, 0) // 8)), 32 * SLOTS - _N_SCALAR)
    while k > 0 and shared_bytes(k) > shared:
        k -= 1
    return k


def max_cols(device) -> int:
    """The most effect columns one launch takes on `device`: C lives in the
    block's shared memory, the chain's state in one warp's registers."""
    if _lib is None:
        build()
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return capacity_for(_max_shared_bytes(index))


def blocks_per_sm(device, n_cols: int) -> int:
    """How many blocks (chains) fit on one SM of `device` at once: the CUDA
    occupancy calculator on the kernel's registers and shared memory."""
    if _lib is None:
        build()
    with torch.cuda.device(device):
        n = _lib.mcgp_hmc_blocks_per_sm(n_cols)
    if n < 0:
        raise HMCKernelError("the occupancy query of the HMC kernel failed")
    return n


def ptxas_facts(log: str) -> dict[str, int]:
    """The kernel's registers, stack frame and spill bytes from the `ptxas
    -v` report kept beside the library (the largest over its instances, one
    per number of parameters a lane holds)."""
    facts, inside = {}, False
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            inside = "hmc_kernel" in m[1]
        elif not inside:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            for key, v in zip(("stack", "spill_stores", "spill_loads"), m.groups()):
                facts[key] = max(facts.get(key, 0), int(v))
        elif m := re.search(r"Used (\d+) registers", line):
            facts["registers"] = max(facts.get("registers", 0), int(m[1]))
    return facts


def _check(kd: KernelDesign, theta, others: dict, iters: int | None = None) -> None:
    """Dtype, shape, contiguity and device of a call's tensors: theta,
    inv_mass and z (chains, dim), the others (chains,); with `iters`, z, u_jit
    and u_acc carry a leading (iters,) axis."""
    if theta.dim() != 2 or theta.shape[1] != kd.dim:
        raise HMCKernelError(f"theta must be (chains, {kd.dim}), got {tuple(theta.shape)}")
    chains = theta.shape[0]
    if chains < 1:
        raise HMCKernelError("theta holds no chain")
    for name, x in {"theta": theta, **others}.items():
        want = (chains, kd.dim) if name in ("theta", "inv_mass", "z") else (chains,)
        if iters is not None and name in ("z", "u_jit", "u_acc"):
            want = (iters, *want)
        if tuple(x.shape) != want:
            raise HMCKernelError(f"{name} must be {want}, got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise HMCKernelError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise HMCKernelError(f"{name} must be contiguous")
        if x.device != theta.device:
            raise HMCKernelError(f"{name} is on {x.device}, theta on {theta.device}")
    if theta.device.type not in ("cpu", "cuda"):
        raise HMCKernelError(f"the HMC kernel runs on cpu or cuda tensors, not {theta.device}")
    if theta.device != kd.device:
        raise HMCKernelError(f"the design is on {kd.device}, theta on {theta.device}")


def require_capacity(n_cols: int, capacity: int, where: str) -> None:
    """Raise `HMCKernelError` when a design of `n_cols` effect columns has
    more than `capacity`, the most one launch takes on the card named
    `where`."""
    if n_cols > capacity:
        raise HMCKernelError(
            f"the HMC kernel keeps the design's K x K counts in one block's shared memory and "
            f"takes at most {capacity} effect columns on {where}; this design has {n_cols}")


# a launch's adaptation constants after the dual averaging's t0, gamma and
# kappa: the target acceptance, log(10) and the variance clamp, float32
_SCALARS = tuple(float(np.float32(x)) for x in (TARGET_ACCEPT, math.log(10.0), VAR_MIN, VAR_MAX))
# the pointers of one fit in a launch, in the C entry's order after counts,
# b and theta
_POINTERS = ("lp", "eps", "inv_mass", "z", "u_jit", "u_acc", "theta_out", "lp_out", "alpha_out",
             "grad_out", "eps_out", "var_out", "lp0_out", "trace_theta", "trace_lp", "trace_eps",
             "trace_alpha")


def slots(kd: KernelDesign) -> int:
    """S, the parameters a lane of warp 0 holds for kd (ceil(dim / 32)):
    the kernel's template argument, which the fits of one launch share."""
    return -(-kd.dim // 32)


def launch_tables(kds: list[KernelDesign], thetas: list, tensors: list[dict]) -> list[tuple]:
    """The C entry's tables for the fits `kds`, fit i from thetas[i] with
    the pointers tensors[i] names: one table per distinct S (`slots`), in
    order of first appearance, each (members, the indices of its fits in
    order; ptrs (fits, 20) uint64: counts, b, theta, then `_POINTERS`, an
    absent or None pointer 0; sizes (fits, 5) int32: n, T, D, C and chains;
    y^T y (fits,) float64; the prior precisions (fits, 4) float32)."""
    groups: dict[int, list[int]] = {}
    for i, kd in enumerate(kds):
        groups.setdefault(slots(kd), []).append(i)
    tables = []
    for members in groups.values():
        fits = [(kds[i], thetas[i], tensors[i]) for i in members]
        ptrs = np.array([[kd.counts.data_ptr(), kd.b.data_ptr(), theta.data_ptr(),
                          *(x[k].data_ptr() if x.get(k) is not None else 0 for k in _POINTERS)]
                         for kd, theta, x in fits], np.uint64)
        sizes = np.array([[kd.n_rows, *kd.sizes, theta.shape[0]] for kd, theta, _ in fits],
                         np.int32)
        yty = np.array([kd.yty for kd, _, _ in fits], np.float64)
        prec = np.array([kd.prior_prec for kd, _, _ in fits], np.float32)
        tables.append((members, ptrs, sizes, yty, prec))
    return tables


def _launch(kds: list[KernelDesign], thetas: list, tensors: list[dict], iters: int,
            n_leapfrog: int, adapt: bool = False) -> int:
    """Launch the kernel on the current stream of theta's device for the
    fits `kds`, fit i from thetas[i] with the pointers tensors[i] names:
    every design checked against the column capacity before anything
    launches, then one launch per table of `launch_tables`, a block per
    chain of every fit of its S. Returns the number of launches."""
    if _lib is None:
        build()
    device = thetas[0].device
    capacity, card = max_cols(device), torch.cuda.get_device_name(device)
    for kd in kds:
        require_capacity(kd.n_cols, capacity, card)
    tables = launch_tables(kds, thetas, tensors)
    for members, ptrs, sizes, yty, prec in tables:
        n = len(members)
        with torch.cuda.device(device):
            # the launch reads its fits' table from here; freed after the call,
            # it is reused only by work later on the same stream
            table = torch.empty(n * _lib.mcgp_hmc_args_bytes(), dtype=torch.uint8, device=device)
            err = _lib.mcgp_hmc_run(
                n, ptrs.ctypes.data, sizes.ctypes.data, yty.ctypes.data, prec.ctypes.data,
                int(adapt), DA_T0, DA_GAMMA, DA_KAPPA, *_SCALARS, iters, n_leapfrog,
                table.data_ptr(), torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise HMCKernelError(f"HMC kernel launch of {n} fits failed: CUDA error {err}")
    return len(tables)


def _check_stage(kd: KernelDesign, theta, eps0, inv_mass, z, u_jit, u_acc,
                 n_leapfrog: int) -> None:
    """A stage's refusals of one fit's inputs."""
    if z.dim() != 3 or z.shape[0] < 1:
        raise HMCKernelError(f"z must be (iters >= 1, chains, dim), got {tuple(z.shape)}")
    _check(kd, theta, dict(eps=eps0, inv_mass=inv_mass, z=z, u_jit=u_jit, u_acc=u_acc),
           z.shape[0])
    if n_leapfrog < 1:
        raise HMCKernelError(f"n_leapfrog must be >= 1, got {n_leapfrog}")


def _stage_tensors(theta, eps0, inv_mass, z, u_jit, u_acc, adapt: bool) -> dict:
    """A stage launch's inputs and new tensors for its outputs, by the C
    entry's names."""
    out = dict(eps=eps0, inv_mass=inv_mass, z=z, u_jit=u_jit, u_acc=u_acc,
               theta_out=torch.empty_like(theta), lp_out=torch.empty_like(eps0),
               alpha_out=torch.empty_like(eps0), lp0_out=torch.empty_like(eps0),
               trace_theta=torch.empty_like(z), trace_lp=torch.empty_like(u_jit),
               trace_eps=torch.empty_like(u_jit), trace_alpha=torch.empty_like(u_jit))
    if adapt:
        out.update(eps_out=torch.empty_like(eps0), var_out=torch.empty_like(theta))
    return out


def _transition_tensors(theta, lp, eps, inv_mass, z, u_jit, u_acc) -> dict:
    """The one-transition entry's inputs (iters = 1, from the given lp) and
    new tensors for (theta', lp', alpha), by the C entry's names."""
    return dict(lp=lp, eps=eps, inv_mass=inv_mass, z=z, u_jit=u_jit, u_acc=u_acc,
                theta_out=torch.empty_like(theta), lp_out=torch.empty_like(lp),
                alpha_out=torch.empty_like(lp))


def _logp_tensors(theta, grad: bool) -> dict:
    """The logp entry's new tensors (iters = 0): lp (chains,) and, with
    `grad`, the gradient (chains, dim), by the C entry's names."""
    lp = torch.empty(theta.shape[0], dtype=torch.float32, device=theta.device)
    return dict(lp_out=lp, grad_out=torch.empty_like(theta) if grad else None)


def _stage_of(out: dict, eps0, adapt: bool) -> Stage:
    return Stage(out["theta_out"], out["lp_out"], out["eps_out"] if adapt else eps0,
                 out.get("var_out"), out["alpha_out"], out["lp0_out"], out["trace_theta"],
                 out["trace_lp"], out["trace_eps"], out["trace_alpha"])


def hmc_stages(kds: list[KernelDesign], thetas: list, eps0s: list, inv_masses: list, zs: list,
               u_jits: list, u_accs: list, n_leapfrog: int, adapt: bool) -> list[Stage]:
    """One stage of every chain of one or more fits: fit i's design and
    inputs are the i-th entries of the lists: theta, inv_mass (chains, dim)
    and eps0 (chains,) as the stage starts, z (iters, chains, dim), u_jit and
    u_acc (iters, chains), float32 and contiguous, on its design's device.
    Every fit runs the same stage: with `adapt` a warmup stage, else
    sampling at eps0, over the same iterations with `n_leapfrog` steps.
    Returns each fit's `Stage` of new tensors, bitwise what the fit gives
    alone.

    CPU tensors run each fit's `stage_plain` in turn, with
    `hmc_transition_plain` steps on its design's plain log posterior. On a
    CUDA device every fit's inputs and its design's column capacity are
    checked before anything launches; then the fits of one S (`slots`) run
    as one launch of the kernel on the current stream, a block per chain of
    every fit, writing the traces as it goes. Each launch counts in
    `hmc_stage.launches`, so a stage takes one launch per distinct S. A
    launch error, a design over the kernel's column capacity, inputs of
    another dtype, shape, layout or device, or fits that differ in device or
    iterations raise `HMCKernelError`."""
    fits = list(zip(kds, thetas, eps0s, inv_masses, zs, u_jits, u_accs))
    if not fits or any(len(x) != len(fits) for x in (kds, thetas, eps0s, inv_masses, zs,
                                                      u_jits, u_accs)):
        raise HMCKernelError("hmc_stages takes one design and one of each input per fit")
    device = thetas[0].device
    for fit in fits:
        _check_stage(*fit, n_leapfrog)
        if fit[1].device != device:
            raise HMCKernelError(f"the fits of one launch share a device: {fit[1].device} and "
                                 f"{device}")
        if fit[4].shape[0] != zs[0].shape[0]:
            raise HMCKernelError(f"the fits of one stage share its iterations: {fit[4].shape[0]} "
                                 f"and {zs[0].shape[0]}")
    if device.type == "cpu":
        return [stage_plain(theta, kd.logp_fn, functools.partial(_plain_step, kd, n_leapfrog),
                            eps0, inv_mass, (z, u_jit, u_acc), adapt)
                for kd, theta, eps0, inv_mass, z, u_jit, u_acc in fits]
    tensors = [_stage_tensors(*fit[1:], adapt) for fit in fits]
    hmc_stage.launches += _launch(kds, thetas, tensors, zs[0].shape[0], int(n_leapfrog), adapt)
    return [_stage_of(out, eps0, adapt) for out, eps0 in zip(tensors, eps0s)]


def hmc_stage(kd: KernelDesign, theta, eps0, inv_mass, z, u_jit, u_acc, n_leapfrog: int,
              adapt: bool) -> Stage:
    """`hmc_stages` of one fit: its `Stage`. `hmc_stage.launches` counts the
    kernel's stage launches of every fit."""
    return hmc_stages([kd], [theta], [eps0], [inv_mass], [z], [u_jit], [u_acc], n_leapfrog,
                      adapt)[0]


hmc_stage.launches = 0


def _plain_step(kd: KernelDesign, n_leapfrog: int, theta, lp, eps, inv_mass, z, u_jit, u_acc):
    return hmc_transition_plain(theta, lp, eps, inv_mass, kd.logp_fn, kd.grad_fn, n_leapfrog,
                                z, u_jit, u_acc)


def hmc_transition(kd: KernelDesign, theta, lp, eps, inv_mass, z, u_jit, u_acc, n_leapfrog: int):
    """One HMC transition of every chain: theta, inv_mass and z (chains, dim),
    lp, eps, u_jit and u_acc (chains,), float32 and contiguous, on kd's
    device. Returns (theta', lp', alpha), new tensors.

    CPU tensors run `hmc_transition_plain` with kd's plain log posterior.
    CUDA tensors launch the kernel for one iteration from the given lp at
    the given eps (the same device code as a stage's transition, so from a
    stage trace's state it gives the trace's next state bitwise); refusals
    raise `HMCKernelError` as in `hmc_stages`."""
    _check(kd, theta, dict(lp=lp, eps=eps, inv_mass=inv_mass, z=z, u_jit=u_jit, u_acc=u_acc))
    if n_leapfrog < 1:
        raise HMCKernelError(f"n_leapfrog must be >= 1, got {n_leapfrog}")
    if theta.device.type == "cpu":
        return _plain_step(kd, n_leapfrog, theta, lp, eps, inv_mass, z, u_jit, u_acc)
    out = _transition_tensors(theta, lp, eps, inv_mass, z, u_jit, u_acc)
    hmc_transition.launches += _launch([kd], [theta], [out], 1, int(n_leapfrog))
    return out["theta_out"], out["lp_out"], out["alpha_out"]


hmc_transition.launches = 0


def hmc_logp(kd: KernelDesign, theta: torch.Tensor, grad: bool = False):
    """logp (chains,) of theta (chains, dim), float32 and contiguous on kd's
    device, and with `grad` also its gradient (chains, dim).

    CPU tensors run kd's plain `logp_fn` (and `grad_fn`). CUDA tensors launch
    the kernel with no transition: the logp a stage starts from."""
    _check(kd, theta, {})
    if theta.device.type == "cpu":
        lp = kd.logp_fn(theta)
        return (lp, kd.grad_fn(theta)) if grad else lp
    out = _logp_tensors(theta, grad)
    hmc_logp.launches += _launch([kd], [theta], [out], 0, 0)
    return (out["lp_out"], out["grad_out"]) if grad else out["lp_out"]


hmc_logp.launches = 0
