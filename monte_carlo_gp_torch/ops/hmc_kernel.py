"""One HMC transition of every chain of the Bayesian qualifying model in one
launch (`csrc/hmc_kernel.cu`), the counterpart of the JAX fit's compiled
leapfrog loop (`monte_carlo_gp_tpu/models/bayesian.py:247-284`, XLA, no
Pallas kernel).

`hmc_transition` takes a transition's inputs (theta, lp, eps, inv_mass, z,
u_jit, u_acc) and returns (theta', lp', alpha). For CPU tensors it runs
`hmc_transition_plain`, the eager transition of `models/bayesian.py`'s fit,
with the plain log posterior (`make_log_posterior`); for CUDA tensors it
launches the kernel, one block per chain, or raises. `hmc_logp` is the
kernel's logp-only entry (each warmup stage's starting logp on the card).
Each counts its launches (`hmc_transition.launches`, `hmc_logp.launches`).

The kernel reads the design through `KernelDesign`: each row's three effect
columns with -y (16 bytes a row) and, per effect column, its rows in row
order (a CSR layout built once per fit on the host), so every column is
summed in a fixed order with no float atomics and a seed gives bitwise the
same fit run to run. The rows' residuals live in shared memory, which bounds
the archive a launch takes (`max_rows`); a larger one raises, naming the
capacity, and is never cut. Every refusal of the wrapper, and a failed
launch, raises `HMCKernelError`. `csr_log_posterior` computes logp and the
gradient in plain PyTorch through the same layout and in the kernel's
summation order; the tests hold it to `make_log_posterior` on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import re
from typing import Callable

import numpy as np
import torch

# threads per block (kThreads in csrc/hmc_kernel.cu): one block per chain
THREADS = 1024
_N_SCALAR = 5  # team_mu and the four log-scales lead theta
_SOURCES = ["hmc_kernel.cu"]
_lib = None


class HMCKernelError(RuntimeError):
    """The HMC kernel's wrapper refused a call (its inputs, or a design over
    the kernel's row capacity), or the launch failed. Not a ValueError: the
    predictor reads a ValueError from a fit as "the archive cannot support a
    fit" and takes the Elo grid instead, and a refused kernel must fail the
    weekend."""


# ---------------------------------------------------------------------------
# The plain version: the eager transition
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


# ---------------------------------------------------------------------------
# The design as the kernel reads it
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelDesign:
    """The training rows of one fit as the kernel reads them, on one device,
    with the plain version's log posterior on the same device.

    `rows` (N, 4) int32 holds each row's team, driver and circuit effect
    columns (t, T + d, T + D + c) and -y as float32 bits; `col_start` (K + 1,)
    and `col_rows` (3N,) int32 list each effect column's rows in row order.
    `prior_prec` are the float32 values 1 / scale² of the four prior scales;
    `logp_fn` and `grad_fn` are `make_log_posterior`'s."""

    rows: torch.Tensor
    col_start: torch.Tensor
    col_rows: torch.Tensor
    sizes: tuple[int, int, int]
    prior_prec: tuple[float, float, float, float]
    logp_fn: Callable
    grad_fn: Callable

    @property
    def n_rows(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_cols(self) -> int:
        return sum(self.sizes)

    @property
    def dim(self) -> int:
        return _N_SCALAR + self.n_cols

    @property
    def device(self) -> torch.device:
        return self.rows.device


def column_layout(team_idx, driver_idx, circuit_idx,
                  sizes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(row_cols (N, 3), col_start (K + 1,), col_rows (3N,)) int32: each row's
    three effect columns, and each column's rows in row order (CSR)."""
    t, d, c = sizes
    parts = [np.asarray(a, np.int64) for a in (team_idx, driver_idx, circuit_idx)]
    for name, idx, size in zip(("team", "driver", "circuit"), parts, sizes):
        if idx.size and (idx.min() < 0 or idx.max() >= size):
            raise HMCKernelError(f"{name} indices must lie in [0, {size})")
    row_cols = np.stack([parts[0], t + parts[1], t + d + parts[2]], axis=1)
    n, k = row_cols.shape[0], t + d + c
    flat = row_cols.reshape(-1)  # row-major: a column meets its rows in row order
    order = np.argsort(flat, kind="stable")
    col_rows = np.repeat(np.arange(n), 3)[order]
    col_start = np.concatenate([[0], np.cumsum(np.bincount(flat, minlength=k))])
    return row_cols.astype(np.int32), col_start.astype(np.int32), col_rows.astype(np.int32)


def kernel_design(y, team_idx, driver_idx, circuit_idx, sizes, prior_scales, logp_fn, grad_fn,
                  device) -> KernelDesign:
    """The `KernelDesign` of the rows (y, team_idx, driver_idx, circuit_idx)
    with (T, D, C) = `sizes` on `device`; `logp_fn` and `grad_fn` are the plain
    log posterior of the same rows on the same device."""
    row_cols, col_start, col_rows = column_layout(team_idx, driver_idx, circuit_idx, sizes)
    neg_y = (-np.asarray(y, np.float32)).view(np.int32)
    rows = np.concatenate([row_cols, neg_y[:, None]], axis=1)
    dev = torch.device(device)
    return KernelDesign(
        rows=torch.from_numpy(np.ascontiguousarray(rows)).to(dev),
        col_start=torch.from_numpy(col_start).to(dev),
        col_rows=torch.from_numpy(col_rows).to(dev),
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


def csr_log_posterior(kd: KernelDesign, theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(logp (chains,), gradient (chains, dim)) of `theta` (chains, dim)
    computed through `kd`'s row and column layout in the kernel's order of
    operations and summation: the rows' sum of err² thread-strided over
    THREADS threads, then a butterfly per warp and one over the warps; each
    column's residuals lane-strided in its CSR order, then a butterfly; the
    parameter sums lane-strided over the effect columns."""
    t, d, _ = kd.sizes
    k = kd.n_cols
    rows = kd.rows.to(theta.device).long()
    neg_y = kd.rows[:, 3].to(theta.device).contiguous().view(torch.float32)
    team_mu, log_sig, raw = theta[:, 0], theta[:, 1:_N_SCALAR], theta[:, _N_SCALAR:]
    sig = torch.exp(log_sig)
    inv_var = torch.exp(-2.0 * log_sig[:, 3])
    seg = torch.cat([torch.full((n,), j, dtype=torch.long, device=theta.device)
                     for j, n in enumerate(kd.sizes)])
    scale = sig[:, seg]
    mask = (seg == 0).to(theta.dtype)
    eff = team_mu[:, None] * mask + raw * scale
    err = eff[:, rows[:, 0]] + eff[:, rows[:, 1]]
    err = err + eff[:, rows[:, 2]]
    err = err + neg_y
    per_thread = _strided_sum(err * err, THREADS)  # (chains, THREADS)
    # each warp's butterfly, then one over the warp partials (lane w: warp w)
    sq = _xor_tree(_xor_tree(per_thread.reshape(-1, THREADS // 32, 32)))
    col_start = kd.col_start.tolist()
    col_rows = kd.col_rows.to(theta.device).long()
    colsum = torch.stack([_lane_sum(err[:, col_rows[col_start[j]:col_start[j + 1]]])
                          for j in range(k)], dim=1)

    g_eff = colsum * -inv_var[:, None]
    zero = torch.zeros_like(g_eff)
    team = _lane_sum(torch.where(seg == 0, g_eff, zero))
    gr = g_eff * raw
    seg_sums = [_lane_sum(torch.where(seg == j, gr, zero)) for j in range(3)]
    g_raw = -raw + scale * g_eff
    g_obs = sq * inv_var - float(kd.n_rows)
    prec = kd.prior_prec
    g_sig = []
    for j in range(4):
        v = 1.0 - (sig[:, j] * sig[:, j]) * prec[j]
        v = v + sig[:, j] * (seg_sums[j] if j < 3 else torch.zeros_like(sq))
        g_sig.append(v + g_obs * (1.0 if j == 3 else 0.0))
    grad = torch.cat([(team - team_mu)[:, None], torch.stack(g_sig, 1), g_raw], dim=1)

    raw2 = _lane_sum(raw * raw)
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
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mcgp_hmc_run.argtypes = [p, p, p, i, i, i, i, f, f, f, f, p, p, p, p, p, p, p, p, p, p, p,
                                 i, i, p]
    lib.mcgp_hmc_run.restype = i
    lib.mcgp_hmc_max_shared_bytes.argtypes = []
    lib.mcgp_hmc_max_shared_bytes.restype = i
    lib.mcgp_hmc_blocks_per_sm.argtypes = [i, i]
    lib.mcgp_hmc_blocks_per_sm.restype = i
    return lib


def shared_bytes(n_rows: int, n_cols: int) -> int:
    """Dynamic shared memory of one block (one chain): the state, the effects
    and every row's residual, float32 (csrc/hmc_kernel.cu: shared_bytes)."""
    return 4 * (5 * (_N_SCALAR + n_cols) + 2 * n_cols + THREADS // 32 + n_rows)


@functools.lru_cache(maxsize=None)
def _max_shared_bytes(device_index: int) -> int:
    with torch.cuda.device(device_index):
        n = _lib.mcgp_hmc_max_shared_bytes()
    if n < 0:
        raise HMCKernelError("the shared-memory query of the HMC kernel failed")
    return n


def max_rows(device, n_cols: int) -> int:
    """The most training rows one launch takes on `device` at `n_cols`
    effect columns: the rows' residuals live in the block's shared memory."""
    if _lib is None:
        build()
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return (_max_shared_bytes(index) - shared_bytes(0, n_cols)) // 4


def blocks_per_sm(device, n_rows: int, n_cols: int) -> int:
    """How many blocks (chains) fit on one SM of `device` at once: the CUDA
    occupancy calculator on the kernel's registers and shared memory."""
    if _lib is None:
        build()
    with torch.cuda.device(device):
        n = _lib.mcgp_hmc_blocks_per_sm(n_rows, n_cols)
    if n < 0:
        raise HMCKernelError("the occupancy query of the HMC kernel failed")
    return n


def ptxas_facts(log: str) -> dict[str, int]:
    """The kernel's registers, stack frame and spill bytes from the `ptxas
    -v` report kept beside the library."""
    facts, inside = {}, False
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            inside = "hmc_kernel" in m[1]
        elif not inside:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            facts.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        elif m := re.search(r"Used (\d+) registers", line):
            facts["registers"] = int(m[1])
    return facts


def _check_state(kd: KernelDesign, theta, others: dict) -> None:
    """Dtype, shape, contiguity and device of a transition's tensors."""
    if theta.dim() != 2 or theta.shape[1] != kd.dim:
        raise HMCKernelError(f"theta must be (chains, {kd.dim}), got {tuple(theta.shape)}")
    chains = theta.shape[0]
    if chains < 1:
        raise HMCKernelError("theta holds no chain")
    for name, x in {"theta": theta, **others}.items():
        want = (chains, kd.dim) if name in ("theta", "inv_mass", "z") else (chains,)
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


def require_capacity(kd: KernelDesign, capacity: int, where: str) -> None:
    """Raise `HMCKernelError` when kd has more rows than `capacity`, the
    most one launch takes on the card named `where`."""
    if kd.n_rows > capacity:
        raise HMCKernelError(
            f"the HMC kernel keeps every row's residual in shared memory and takes at most "
            f"{capacity} rows at {kd.n_cols} effect columns on {where}; this design has "
            f"{kd.n_rows}")


def _launch(kd: KernelDesign, theta, n_leapfrog: int, lp=None, eps=None, inv_mass=None, z=None,
            u_jit=None, u_acc=None, theta_out=None, lp_out=None, alpha_out=None, grad_out=None):
    if _lib is None:
        build()
    t, d, c = kd.sizes
    card = torch.cuda.get_device_name(theta.device)
    require_capacity(kd, max_rows(theta.device, kd.n_cols), card)
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(theta.device):
        err = _lib.mcgp_hmc_run(
            kd.rows.data_ptr(), kd.col_start.data_ptr(), kd.col_rows.data_ptr(), kd.n_rows, t, d, c,
            *kd.prior_prec, theta.data_ptr(), ptr(lp), ptr(eps), ptr(inv_mass), ptr(z), ptr(u_jit),
            ptr(u_acc), ptr(theta_out), lp_out.data_ptr(), ptr(alpha_out), ptr(grad_out),
            theta.shape[0], n_leapfrog, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise HMCKernelError(f"HMC kernel launch failed: CUDA error {err}")


def hmc_transition(kd: KernelDesign, theta, lp, eps, inv_mass, z, u_jit, u_acc, n_leapfrog: int):
    """One HMC transition of every chain: theta, inv_mass and z (chains, dim),
    lp, eps, u_jit and u_acc (chains,), float32 and contiguous, on kd's
    device. Returns (theta', lp', alpha), new tensors.

    CPU tensors run `hmc_transition_plain` with kd's plain log posterior.
    CUDA tensors launch the kernel on the current stream (one block per
    chain); a launch error, or a design over the kernel's row capacity,
    raises `HMCKernelError`, as do inputs of another dtype, shape, layout
    or device."""
    _check_state(kd, theta, dict(lp=lp, eps=eps, inv_mass=inv_mass, z=z, u_jit=u_jit, u_acc=u_acc))
    if n_leapfrog < 1:
        raise HMCKernelError(f"n_leapfrog must be >= 1, got {n_leapfrog}")
    if theta.device.type == "cpu":
        return hmc_transition_plain(theta, lp, eps, inv_mass, kd.logp_fn, kd.grad_fn, n_leapfrog,
                                    z, u_jit, u_acc)
    theta_out, lp_out, alpha = torch.empty_like(theta), torch.empty_like(lp), torch.empty_like(lp)
    _launch(kd, theta, int(n_leapfrog), lp, eps, inv_mass, z, u_jit, u_acc, theta_out, lp_out,
            alpha)
    hmc_transition.launches += 1
    return theta_out, lp_out, alpha


hmc_transition.launches = 0


def hmc_logp(kd: KernelDesign, theta: torch.Tensor, grad: bool = False):
    """logp (chains,) of theta (chains, dim), float32 and contiguous on kd's
    device, and with `grad` also its gradient (chains, dim).

    CPU tensors run kd's plain `logp_fn` (and `grad_fn`). CUDA tensors launch
    the kernel with no leapfrog step, so the logp has the summation order of
    the lp the transitions return."""
    _check_state(kd, theta, {})
    if theta.device.type == "cpu":
        lp = kd.logp_fn(theta)
        return (lp, kd.grad_fn(theta)) if grad else lp
    lp = torch.empty(theta.shape[0], dtype=torch.float32, device=theta.device)
    g = torch.empty_like(theta) if grad else None
    _launch(kd, theta, 0, lp_out=lp, grad_out=g)
    hmc_logp.launches += 1
    return (lp, g) if grad else lp


hmc_logp.launches = 0
