"""The whole-race Monte Carlo: each simulation runs one full race (grid,
lap 1, laps 2..race_laps, classification) and adds its finishing order to a
(D, D) [driver, position] histogram.

`race_counts` is the entry point for one race, `season_counts` for a
season of races in one launch. For CPU tensors they run `race_counts_plain`
and `season_counts_plain`, the plain PyTorch versions; for CUDA tensors
they launch the hand-written kernels in `csrc/race_kernel.cu` (one race body
for both: three simulations a warp of two cars a lane up to 20 drivers, one
simulation a warp of ceil(D / 32) cars a lane above; `kernel_tier`), or
raise.
`race_counts_sharded` and `season_counts_sharded` split the simulations over
a mesh of devices (`parallel/mesh.py`) and sum the shards' counts, with one
all-reduce across processes. Both follow the Pallas kernel
body `monte_carlo_gp_tpu/ops/pallas_engine.py::_race_kernel` operation for
operation, in float32 and in the same order, and draw from the same Philox
stream (`ops/philox.py`), so on the same inputs they agree up to the last
bits of `log`/`cos`. With all-zero bits `race_counts_plain` reproduces the
Pallas body's interpreter run exactly (tests/test_torch_race_kernel.py).

The draw order per simulation, k = 0, 1, ...: one draw per grid slot (D
slots); lap 1: the lap-1 DNF draw and two normals (two draws each); each
lap 2..race_laps: race control (8 rows), DNF, one normal, one draw per
overtake pass (3 passes).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from monte_carlo_gp_torch import config as cfg
from monte_carlo_gp_torch.config import SimParams, pad_params
from monte_carlo_gp_torch.ops import philox
from monte_carlo_gp_torch.ops.ranking import inverse_permutation, rank_key, rank_tier
from monte_carlo_gp_torch.parallel import distributed
from monte_carlo_gp_torch.parallel.mesh import Mesh, local_shards, resolve_mesh
from monte_carlo_gp_torch.utils.profiling import count

INF = 1e30

# scalar pack layout: the Pallas kernel's SMEM pack without its lap count,
# which is a launch argument here
(
    _PIT_LOSS, _OVERTAKE_DELTA, _DRS_DELTA, _SC_P, _VSC_P, _RED_P,
    _DIRTY_THRESH, _DIRTY_PEN, _TRACK_COND,
    _CPACE0, _CPACE1, _CPACE2, _CPACE3, _CPACE4,
    _CDEG0, _CDEG1, _CDEG2, _CDEG3, _CDEG4,
    _COPT0, _COPT1, _COPT2, _COPT3, _COPT4,
    N_SCALARS,
) = range(25)

# per-driver parameter matrix columns, (D, 8)
_BASE, _DEG, _VAR, _DNF, _TEAMDNF, _ACTIVE = range(6)
N_PCOLS = 8

# The rank keys pack (quantized time) * M + row; M = 128 bounds the field
# of both the plain version and the CUDA kernels (the same limit as the
# Pallas kernel). Wider fields run on the lap engine (ops/engine.py).
MAX_DRIVERS = 128

_RACE_CONTROL_ROWS = 8


def pack_inputs(params: SimParams) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pmat (D, 8), scal (24,), grid_log (D, D)) float32 on the params'
    device — the kernel's three inputs."""
    d = params.n_drivers
    dev = params.device
    pmat = torch.zeros((d, N_PCOLS), dtype=torch.float32, device=dev)
    pmat[:, _BASE] = params.base_pace
    pmat[:, _DEG] = params.tire_deg
    pmat[:, _VAR] = params.variance
    pmat[:, _DNF] = params.dnf_rate
    pmat[:, _TEAMDNF] = params.team_dnf_rate
    pmat[:, _ACTIVE] = params.active.to(torch.float32)
    scal = torch.cat(
        [
            torch.stack(
                [
                    params.pit_loss, params.overtake_delta, params.drs_delta,
                    params.sc_prob, params.vsc_prob, params.red_flag_prob,
                    params.dirty_air_threshold, params.dirty_air_penalty,
                    params.track_condition.to(torch.float32),
                ]
            ),
            params.compound_pace,
            params.compound_deg,
            params.compound_optimal.to(torch.float32),
        ]
    )
    safe = params.grid_probs.clamp_min(0.0)
    grid_log = torch.where(safe > 0, torch.log(safe.clamp_min(1e-38)), -INF)
    return pmat.contiguous(), scal.contiguous(), grid_log.to(torch.float32).contiguous()


def pack_season_inputs(
    params_list: list[SimParams],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """(pmat_s (R, D, 8), scal_s (R, 24), grid_log_s (R, D, D), D) for a
    season of R races on their params' device, D the widest field. Narrower
    fields are padded by `config.pad_params`, as
    `monte_carlo_gp_tpu.parallel.sharded.stack_params` pads them: padding
    slots are inactive (they start retired and classify after every real
    car), with zero pace, degradation, variance and DNF rates and zero grid
    probabilities (-1e30 in grid_log)."""
    if not params_list:
        raise ValueError("a season needs at least one race")
    d_max = max(p.n_drivers for p in params_list)
    packed = [pack_inputs(pad_params(p, d_max)) for p in params_list]
    pmat_s, scal_s, grid_log_s = (torch.stack(parts).contiguous() for parts in zip(*packed))
    return pmat_s, scal_s, grid_log_s, d_max


def _ranks(key):
    """(rank, order) over the driver axis for UNIQUE keys: rank_i =
    #{j: k_j < k_i} and order[p] = the row of rank p. A sort gives the same
    ranks as the Pallas kernel's pairwise count because no two keys tie."""
    order = torch.argsort(key, dim=1)
    return inverse_permutation(order), order


def _rank_of_tiebreak(key, row):
    """(value, row)-lexicographic ranks over possibly tied float keys."""
    kj, ki = key[:, None, :], key[:, :, None]
    before = (kj < ki) | ((kj == ki) & (row[:, None, :] < row[:, :, None]))
    return before.sum(-1, dtype=torch.int32)


def _condition_compound(track: int, remaining: int) -> int:
    dry = cfg.HARD if remaining > 30 else (cfg.MEDIUM if remaining > 15 else cfg.SOFT)
    if track == cfg.FULL_WET:
        return cfg.WET
    return cfg.INTERMEDIATE if track == cfg.DAMP else dry


def _overtake_pass(cum, pace, att, u, pass_active, key_of, tenth, overtake_delta: float):
    """One overtake pass of n simulations -> (cum after it, (n, 1) whether
    the simulation swapped). cum, pace, att and u are (n, D) by car (u by
    position); `key_of(cum)` gives the rank keys and `tenth` is 0.1 * the
    position; a simulation whose `pass_active` is False swaps nothing.

    In position space, row p of r_* is the car at position p. The
    reference's sequential time-rewrite chain
      nb = max(0.1, rows[p-1] - 0.1); if swap[p]: rows[p-1] = nb + 0.3; rows[p] = nb
    is evaluated in the Pallas kernel's closed form, a prefix max of
    z = where(swapped, -inf, r_cum + 0.1 p) (the two differ by ULPs). Where
    nothing swaps the pass gives every car its own time back, bit for bit,
    which lets the CUDA kernel skip a dead pass's work."""
    n, d = cum.shape
    orank, inv = _ranks(key_of(cum))
    r_cum, r_pace, r_att = (x.gather(1, inv) for x in (cum, pace, att))
    delta = r_pace[:, :-1] - r_att[:, 1:]
    prob = (delta * 0.5).clamp_max(0.5)
    swap = (delta > overtake_delta) & (u[:, 1:] < prob) & pass_active
    no_swap = torch.zeros((n, 1), dtype=torch.bool, device=cum.device)
    swapped = torch.cat([no_swap, swap], 1)
    z = torch.where(swapped, -INF, r_cum + tenth)
    dist = 1
    while dist < d:
        shifted = torch.cat(
            [torch.full((n, dist), -INF, dtype=torch.float32, device=cum.device), z[:, : d - dist]], 1
        )
        z = torch.maximum(z, shifted)
        dist *= 2
    a = torch.where(swapped, (z - tenth).clamp_min(0.1), r_cum)
    swap_next = torch.cat([swapped[:, 1:], no_swap], 1)
    final = torch.where(swap_next, (a - 0.1).clamp_min(0.1) + 0.3, a)
    return final.gather(1, orank), swap.any(1, keepdim=True)


def _simulate(pmat, scal, grid_log, race_laps: int, bits, n: int):
    """One chunk of `n` simulations -> final positions (n, D), 1-based."""
    dev = pmat.device
    d = pmat.shape[0]
    f32, i32 = torch.float32, torch.int32
    q_shift, row_mult = rank_tier(d)
    s = scal.tolist()  # exact float32 values as Python floats
    track = int(s[_TRACK_COND])
    drs_delta = s[_DRS_DELTA]
    overtake_delta = s[_OVERTAKE_DELTA]
    draw = 0

    def uniform(rows: int = d):
        nonlocal draw
        words = bits(draw, rows)
        draw += 1
        return (words >> 8).to(f32) * (1.0 / 16777216.0)

    def normal():
        u1 = uniform().clamp_min(5.9604645e-8)
        u2 = uniform()
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(6.2831853 * u2)

    row = torch.arange(d, dtype=i32, device=dev)[None, :]
    tenth = row.to(f32) * 0.1
    active = (pmat[:, _ACTIVE] > 0.5)[None, :].expand(n, d)
    base_pace = pmat[None, :, _BASE]
    driver_deg = pmat[None, :, _DEG]
    variance = pmat[None, :, _VAR]
    dnf_rate = pmat[None, :, _DNF]
    team_dnf = pmat[None, :, _TEAMDNF]
    cdeg = scal[_CDEG0 : _CDEG0 + 5]
    cpace = scal[_CPACE0 : _CPACE0 + 5]
    copt = scal[_COPT0 : _COPT0 + 5]
    factor = torch.where(driver_deg > 0, driver_deg / 0.05, 1.0)

    def key_of(cum, dnf=None):
        return rank_key(cum, row, q_shift, row_mult, dnf)

    def clean_lap_time(comp, age, fuel, drs, noise):
        return (
            base_pace
            + age * cdeg[comp] * factor
            - (110.0 - fuel) * 0.03
            + cpace[comp]
            - torch.where(drs, drs_delta, 0.0)
            + variance * noise
        )

    # ---- grid: masked Gumbel-max per slot --------------------------------
    remaining = active.clone()
    start_pos = torch.full((n, d), d, dtype=i32, device=dev)
    for pos in range(d):
        masked = torch.where(remaining, grid_log[None, :, pos], -INF)
        col_empty = masked.amax(1, keepdim=True) <= -INF / 2
        logits = torch.where(col_empty & remaining, 0.0, masked)
        u = uniform().clamp_min(5.9604645e-8)
        score = torch.where(remaining, logits + (-torch.log(-torch.log(u))), -INF)
        best = score.amax(1, keepdim=True)
        is_best = (score == best) & remaining
        first = torch.where(is_best, row, d).amin(1, keepdim=True)
        take = (row == first) & remaining.any(1, keepdim=True)
        start_pos = torch.where(take, pos, start_pos)
        remaining = remaining & ~take

    # ---- car init ----------------------------------------------------------
    top10 = start_pos < 10
    if track == cfg.FULL_WET:
        compound = torch.full((n, d), cfg.WET, dtype=torch.long, device=dev)
    elif track == cfg.DAMP:
        compound = torch.full((n, d), cfg.INTERMEDIATE, dtype=torch.long, device=dev)
    else:
        compound = torch.where(top10, cfg.SOFT, cfg.MEDIUM).long()
    age = torch.where(top10 & (track == cfg.DRY), 4.0, 0.0)
    used_s = compound == cfg.SOFT
    used_m = compound == cfg.MEDIUM
    used_h = compound == cfg.HARD
    zeros = torch.zeros((n, d), dtype=f32, device=dev)
    fuel = zeros + 110.0
    cum, last_lap, behind, dnf_lap, laps_done = zeros, zeros, zeros, zeros, zeros
    dnf = ~active
    drs = torch.zeros((n, d), dtype=torch.bool, device=dev)
    drs_until = torch.zeros((n, 1), dtype=f32, device=dev)

    # ---- lap 1 ---------------------------------------------------------------
    lap1_dnf = ~dnf & (uniform() < team_dnf * 4.0)
    base_lap = clean_lap_time(compound, age, fuel, drs, normal())
    position = start_pos.to(f32) + 1.0
    sigma = (0.5 + position * 0.1).clamp_max(1.5)
    start_delta = sigma * normal()
    start_delta = torch.where(position <= 3, start_delta.clamp_max(1.0), start_delta)
    lap_time = base_lap - start_delta * 0.5
    alive = ~dnf & ~lap1_dnf
    dnf = dnf | lap1_dnf
    dnf_lap = torch.where(lap1_dnf, 1.0, dnf_lap)
    cum = torch.where(alive, cum + lap_time, cum)
    age = torch.where(alive, age + 1.0, age)
    fuel = torch.where(alive, (fuel - 1.5).clamp_min(0.0), fuel)
    leader = torch.where(dnf, INF, cum).amin(1, keepdim=True)
    behind = torch.where(dnf, behind, cum - leader)
    urank, _ = _ranks(key_of(cum, dnf))
    # value of the car one rank ahead's last lap, carried from the previous
    # lap's position update (last_lap is all zero after lap 1)
    ahead_ll = zeros

    # ---- laps 2..race_laps ------------------------------------------------------
    for lap in range(2, race_laps + 1):
        act = ~dnf
        u_rc = uniform(_RACE_CONTROL_ROWS)
        is_red = u_rc[:, 0:1] < s[_RED_P]
        is_sc = ~is_red & (u_rc[:, 1:2] < s[_SC_P])
        is_vsc = ~is_red & ~is_sc & (u_rc[:, 2:3] < s[_VSC_P])
        vsc_refund = is_vsc & (u_rc[:, 3:4] < 0.3)

        # The rank carried from the previous lap's position update is still
        # this lap's race-control rank (cum and dnf are unchanged since).
        rank = urank
        leader = torch.where(dnf, INF, cum).amin(1, keepdim=True)
        leader_laps = torch.where((rank == 0) & act, laps_done, 0.0).sum(1, keepdim=True)
        rank_f = rank.to(f32)
        laps_down = leader_laps - laps_done
        sc_time = leader + rank_f * 0.5 + torch.where(laps_down > 0, laps_down * 90.0, 0.0)
        vsc_time = leader + (cum - leader) * 0.8
        red_time = leader + rank_f * 0.1
        m_red = is_red & act
        m_sc = is_sc & act
        m_vsc = is_vsc & act
        cum = torch.where(
            m_red, red_time, torch.where(m_sc, sc_time, torch.where(m_vsc, vsc_time, cum))
        )
        behind = torch.where(m_red | m_sc | m_vsc, cum - leader, behind)
        refund = m_sc | (vsc_refund & act)
        age = torch.where(
            m_red, 0.0, torch.where(refund, (age - 1.0).clamp_min(0.0), age)
        )
        remaining_laps = race_laps - lap
        red_compound = _condition_compound(track, remaining_laps)
        compound = torch.where(m_red, red_compound, compound)
        used_s = used_s | (m_red & (red_compound == cfg.SOFT))
        used_m = used_m | (m_red & (red_compound == cfg.MEDIUM))
        used_h = used_h | (m_red & (red_compound == cfg.HARD))
        drs_until = torch.where(
            is_red | is_sc, lap + 2.0, torch.where(is_vsc, lap + 1.0, drs_until)
        )

        # DNF draw + lap time (dirty air from the carried lap of the car ahead)
        new_dnf = act & (uniform() < dnf_rate)
        alive = act & ~new_dnf
        clean = clean_lap_time(compound, age, fuel, drs, normal())
        in_dirty = (behind > 0) & (ahead_ll > 0) & (behind < s[_DIRTY_THRESH])
        lap_time = torch.where(
            in_dirty, torch.maximum(clean + s[_DIRTY_PEN], ahead_ll), clean
        )
        dnf = dnf | new_dnf
        dnf_lap = torch.where(new_dnf, float(lap), dnf_lap)
        cum = torch.where(alive, cum + lap_time, cum)
        last_lap = torch.where(alive, lap_time, last_lap)
        age = torch.where(alive, age + 1.0, age)
        fuel = torch.where(alive, (fuel - 1.5).clamp_min(0.0), fuel)
        laps_done = torch.where(alive, laps_done + 1.0, laps_done)

        # pit stops and the two-dry-compound rule
        opt = copt[compound]
        opt_adj = torch.where(
            driver_deg > 0.05,
            torch.floor(opt * 0.85),
            torch.where(driver_deg < 0.02, torch.floor(opt * 1.1), opt),
        )
        pit = ~dnf & (age > opt_adj) & (remaining_laps > 5)
        target = _condition_compound(track, remaining_laps)
        n_used_dry = used_s.to(i32) + used_m.to(i32) + used_h.to(i32)
        repeats = {cfg.SOFT: used_s, cfg.MEDIUM: used_m, cfg.HARD: used_h}.get(target)
        if repeats is not None and track == cfg.DRY:
            must_switch = (n_used_dry == 1) & repeats
            if remaining_laps > 20:
                alt = torch.where(~used_m, cfg.MEDIUM, cfg.HARD)
            else:
                alt = torch.where(~used_s, cfg.SOFT, cfg.MEDIUM)
            new_compound = torch.where(must_switch, alt, target).long()
        else:
            new_compound = torch.full_like(compound, target)
        cum = torch.where(pit, cum + s[_PIT_LOSS], cum)
        compound = torch.where(pit, new_compound, compound)
        used_s = used_s | (pit & (new_compound == cfg.SOFT))
        used_m = used_m | (pit & (new_compound == cfg.MEDIUM))
        used_h = used_h | (pit & (new_compound == cfg.HARD))
        age = torch.where(pit, 0.0, age)

        # overtakes: 3 passes in position space; a pass after one without a
        # swap is dead (it swaps nothing) but still takes its draw
        pace = torch.where(dnf, float("nan"), base_pace + age * driver_deg)
        att = pace - torch.where(drs, drs_delta, 0.0)
        pass_active = torch.ones((n, 1), dtype=torch.bool, device=dev)
        for _ in range(3 if d > 1 else 0):
            cum, swapped = _overtake_pass(
                cum, pace, att, uniform(), pass_active, key_of, tenth, overtake_delta
            )
            pass_active = pass_active & swapped

        # position / DRS update
        urank, order = _ranks(key_of(cum, dnf))
        leader = torch.where(dnf, INF, cum).amin(1, keepdim=True)
        behind = torch.where(dnf, behind, cum - leader)
        ahead = order.gather(1, (urank - 1).clamp_min(0))
        has_ahead = urank > 0
        ahead_cum = torch.where(has_ahead, cum.gather(1, ahead), 0.0)
        ahead_ll = torch.where(has_ahead, last_lap.gather(1, ahead), 0.0)
        gap_ahead = cum - ahead_cum
        drs = (
            (lap > 2)
            & ~(lap <= drs_until)
            & has_ahead
            & (gap_ahead < 1.0)
            & ~dnf
        )

    # ---- classification: (dnf, dnf_lap desc, cum desc, row) ---------------------
    key_t = torch.where(dnf, INF, cum)
    active_rank = _rank_of_tiebreak(key_t, row)
    n_active = (~dnf).sum(1, keepdim=True, dtype=i32)
    lap_j, lap_i = dnf_lap[:, None, :], dnf_lap[:, :, None]
    cum_j, cum_i = cum[:, None, :], cum[:, :, None]
    greater = (lap_j > lap_i) | (
        (lap_j == lap_i)
        & ((cum_j > cum_i) | ((cum_j == cum_i) & (row[:, None, :] < row[:, :, None])))
    )
    dnf_rank = (greater & dnf[:, None, :] & dnf[:, :, None]).sum(-1, dtype=i32)
    return torch.where(dnf, n_active + dnf_rank, active_rank) + 1


def _check_inputs(pmat, scal, grid_log, race_laps, n_sims, sim_offset):
    d = pmat.shape[0] if pmat.dim() == 2 else -1
    if pmat.shape != (d, N_PCOLS) or grid_log.shape != (d, d) or scal.shape != (N_SCALARS,):
        raise ValueError(
            f"expected pmat (D, {N_PCOLS}), scal ({N_SCALARS},), grid_log (D, D); got "
            f"{tuple(pmat.shape)}, {tuple(scal.shape)}, {tuple(grid_log.shape)}"
        )
    for name, t in (("pmat", pmat), ("scal", scal), ("grid_log", grid_log)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != pmat.device:
            raise ValueError(f"{name} is on {t.device}, pmat on {pmat.device}")
    if not 1 <= d <= MAX_DRIVERS:
        raise ValueError(
            f"{d} drivers: the race kernel takes 1..{MAX_DRIVERS} (its rank keys "
            f"pack *{MAX_DRIVERS}+row); wider fields run on ops.engine.run_monte_carlo"
        )
    if race_laps < 1:
        raise ValueError(f"race_laps must be >= 1, got {race_laps}")
    if n_sims < 0 or sim_offset < 0 or sim_offset + n_sims > 2**32:
        raise ValueError("simulation indices must lie in [0, 2**32)")
    return d


def race_counts_plain(
    pmat: torch.Tensor,
    scal: torch.Tensor,
    grid_log: torch.Tensor,
    race_laps: int,
    n_sims: int,
    seed: int = 0,
    sim_offset: int = 0,
    bits=None,
) -> torch.Tensor:
    """The plain PyTorch version of the race kernel, on pmat's device:
    (D, D) int64 [driver, position] finish counts of simulations
    [sim_offset, sim_offset + n_sims).

    `bits(k, rows)` supplies draw k's (n_sims, rows) uint32 words (in int64);
    the default is the Philox stream of `seed`, and then simulations are
    processed in chunks to bound memory (the stream's counter is the global
    simulation index, so the chunking does not change the result)."""
    d = _check_inputs(pmat, scal, grid_log, race_laps, n_sims, sim_offset)
    counts = torch.zeros(d * d, dtype=torch.int64, device=pmat.device)
    if bits is not None:
        chunk = n_sims
    else:
        # measured best on a CPU: tensors of ~4096 x 20 stay in cache
        chunk = (4096 if pmat.device.type == "cpu" else 131072) * 32 // max(32, d)
    row = torch.arange(d, device=pmat.device)[None, :]
    for lo in range(0, n_sims, max(1, chunk)):
        n = min(chunk, n_sims - lo)
        src = bits if bits is not None else philox.PhiloxBits(
            seed, sim_offset + lo, n, max(d, _RACE_CONTROL_ROWS), pmat.device
        )
        pos = _simulate(pmat, scal, grid_log, int(race_laps), src, n)
        counts += torch.bincount((row * d + pos - 1).flatten(), minlength=d * d)
    return counts.view(d, d)


def _check_season_inputs(pmat_s, scal_s, grid_log_s, race_laps, n_sims, seeds, sim_offset=0):
    """(R, D, race_laps as ints, seeds as ints) after the single-race checks
    on every race of the season."""
    if pmat_s.dim() != 3 or scal_s.dim() != 2 or grid_log_s.dim() != 3:
        raise ValueError(
            f"expected pmat_s (R, D, {N_PCOLS}), scal_s (R, {N_SCALARS}), grid_log_s "
            f"(R, D, D); got {tuple(pmat_s.shape)}, {tuple(scal_s.shape)}, "
            f"{tuple(grid_log_s.shape)}"
        )
    n_races = pmat_s.shape[0]
    laps = [int(x) for x in race_laps]
    seeds = [int(x) for x in seeds]
    if n_races < 1 or not n_races == scal_s.shape[0] == grid_log_s.shape[0] == len(laps) == len(seeds):
        raise ValueError(
            f"a season of {n_races} races needs that many scal_s and grid_log_s rows, "
            f"lap counts and seeds; got {scal_s.shape[0]}, {grid_log_s.shape[0]}, "
            f"{len(laps)}, {len(seeds)}"
        )
    for name, t in (("pmat_s", pmat_s), ("scal_s", scal_s), ("grid_log_s", grid_log_s)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for r in range(n_races):
        d = _check_inputs(pmat_s[r], scal_s[r], grid_log_s[r], laps[r], n_sims, sim_offset)
        philox.seed_key(seeds[r])
    return n_races, d, laps, seeds


def season_counts_plain(
    pmat_s: torch.Tensor,
    scal_s: torch.Tensor,
    grid_log_s: torch.Tensor,
    race_laps,
    n_sims_per_race: int,
    seeds,
    sim_offset: int = 0,
    bits=None,
) -> torch.Tensor:
    """The plain PyTorch version of the season kernel, on pmat_s's device:
    (R, D, D) int64 counts, race r being `race_counts_plain` of race r's
    inputs, its own lap count `race_laps[r]` and simulations
    [sim_offset, sim_offset + n_sims_per_race) of the stream of `seeds[r]`
    (or of `bits`, the same bit source for every race)."""
    n_races, _, laps, seeds = _check_season_inputs(
        pmat_s, scal_s, grid_log_s, race_laps, n_sims_per_race, seeds, sim_offset
    )
    return torch.stack([
        race_counts_plain(
            pmat_s[r], scal_s[r], grid_log_s[r], laps[r], n_sims_per_race, seeds[r],
            sim_offset, bits=bits,
        )
        for r in range(n_races)
    ])


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_lib = None
_SOURCES = ["race_kernel.cu"]


def is_built() -> bool:
    """Whether the CUDA library of the current sources is already built, so
    that first use only loads it."""
    from monte_carlo_gp_torch.ops._build import library_path

    return library_path("race_kernel", _SOURCES).exists()


def build():
    """Build (or find) the CUDA library and load it; returns its path."""
    global _lib
    from monte_carlo_gp_torch.ops._build import build_cuda_library

    path = build_cuda_library("race_kernel", _SOURCES)
    if _lib is None:
        lib = load_library(path)
        check_instances(lib)
        _lib = lib
    return path


def check_instances(lib) -> None:
    """Raise unless the library runs every field width 1..128 on the
    instance `kernel_tier` gives (`library_tier`)."""
    wrong = [d for d in range(1, 129) if library_tier(lib, d) != kernel_tier(d)]
    if wrong:
        raise RuntimeError(
            f"the race-kernel library runs {len(wrong)} field widths (first {wrong[0]}) on "
            f"another instance than kernel_tier gives: update kernel_tier with the kernels"
        )


def load_library(path) -> ctypes.CDLL:
    """A built race-kernel library with its C entry points' signatures set."""
    lib = ctypes.CDLL(str(path))
    fn = lib.mcgp_race_counts
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.mcgp_season_counts
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.mcgp_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    if hasattr(lib, "mcgp_sims_per_warp"):  # not in a library from before the packed instance
        for fn in (lib.mcgp_cars_per_lane, lib.mcgp_sims_per_warp):
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_int
    return lib


def race_counts(
    pmat: torch.Tensor,
    scal: torch.Tensor,
    grid_log: torch.Tensor,
    race_laps: int,
    n_sims: int,
    seed: int = 0,
    sim_offset: int = 0,
    warps_per_block: int | None = None,
    n_blocks: int | None = None,
) -> torch.Tensor:
    """(D, D) [driver, position] finish counts of simulations
    [sim_offset, sim_offset + n_sims) of the Philox stream of `seed`.

    CPU tensors run `race_counts_plain` (int64 counts). CUDA tensors launch
    the CUDA kernel on the current stream (int32 counts); a launch error
    raises. The counts do not depend on `warps_per_block` or `n_blocks`
    (default: the block shape and grid of `launch_shape`)."""
    if pmat.device.type == "cpu":
        return race_counts_plain(pmat, scal, grid_log, race_laps, n_sims, seed, sim_offset)
    if pmat.device.type != "cuda":
        raise ValueError(f"race_counts runs on cpu or cuda tensors, not {pmat.device}")
    d = _check_inputs(pmat, scal, grid_log, race_laps, n_sims, sim_offset)
    _check_warps(warps_per_block)
    key0, key1 = philox.seed_key(seed)
    counts = torch.zeros((d, d), dtype=torch.int32, device=pmat.device)
    if n_sims == 0:
        return counts
    with torch.cuda.device(pmat.device):
        warps_per_block, full_grid = launch_shape(pmat.device, d, warps_per_block)
        tier = library_tier(_lib, d)
        n_blocks = grid_blocks(n_sims, tier[1], warps_per_block,
                               full_grid if n_blocks is None else n_blocks)
        if not 1 <= n_blocks <= 2**31 - 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        err = _lib.mcgp_race_counts(
            pmat.data_ptr(), scal.data_ptr(), grid_log.data_ptr(), counts.data_ptr(),
            d, int(race_laps), key0, key1, sim_offset, n_sims,
            warps_per_block, n_blocks, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"race kernel launch failed: CUDA error {err}")
    race_counts.launches += 1
    _count_launch(tier, [d], n_sims)
    return counts


race_counts.launches = 0


def slot_counts(tier: tuple[int, int], fields, n_sims: int) -> tuple[int, int]:
    """(cars, slots) of a launch of `n_sims` simulations of races whose
    fields hold `fields` drivers, on the instance `tier` (cars per lane,
    simulations per warp; `library_tier`): the cars the races carry, and
    the lanes x cars its warps issue, ceil(n_sims / sims_per_warp) warps of
    32 lanes a race, padding slots and idle lanes included. Their ratio is
    the launch's slot fill: 22 / 32 at 22 drivers, 60 / 64 at 20 on the
    packed instance."""
    cars_per_lane, sims_per_warp = tier
    warps = -(-n_sims // sims_per_warp)
    return n_sims * sum(fields), len(fields) * warps * 32 * cars_per_lane


def _count_launch(tier: tuple[int, int], fields, n_sims: int) -> None:
    """The counters of a launch on the card: `race.cars` and `race.slots`
    (`slot_counts`), and `race.packed`, its races on the packed instance."""
    cars, slots = slot_counts(tier, fields, n_sims)
    count("race.cars", cars)
    count("race.slots", slots)
    if tier[1] > 1:
        count("race.packed", len(fields))


def _check_warps(warps_per_block: int | None) -> None:
    if warps_per_block is not None and not 1 <= warps_per_block <= 32:
        raise ValueError(f"warps_per_block must be in 1..32, got {warps_per_block}")


# A full launch is this many waves of the blocks that fit on every SM at once.
GRID_WAVES = 4
# The block shapes the default picks from, in order of preference.
BLOCK_SHAPES = (8, 12, 4)
# Fields of up to PACKED_DRIVERS drivers take the kernels' packed instance:
# PACKED_SIMS simulations a warp, each on 10 lanes of PACKED_CARS cars.
PACKED_DRIVERS, PACKED_SIMS, PACKED_CARS = 20, 3, 2


def kernel_tier(d: int) -> tuple[int, int]:
    """(cars per lane, simulations per warp) of the kernel instance that
    runs a field of d drivers, as `csrc/race_kernel.cu` chooses it (`build`
    checks that the library agrees): the packed (PACKED_CARS, PACKED_SIMS)
    up to PACKED_DRIVERS, else (ceil(d / 32), 1)."""
    return (PACKED_CARS, PACKED_SIMS) if d <= PACKED_DRIVERS else (-(-d // 32), 1)


def library_tier(lib, d: int) -> tuple[int, int]:
    """(cars per lane, simulations per warp) of the instance that a loaded
    library runs a field of d drivers on, as the library reports it. A
    library from before the packed instance (`profile_kernel --against` an
    older source) reports nothing: it runs one simulation a warp of
    ceil(d / 32) cars a lane."""
    if not hasattr(lib, "mcgp_sims_per_warp"):
        return -(-d // 32), 1
    return lib.mcgp_cars_per_lane(d), lib.mcgp_sims_per_warp(d)


def grid_blocks(n_sims: int, sims_per_warp: int, warps_per_block: int, most: int) -> int:
    """The blocks of a launch of n_sims simulations on an instance of
    `sims_per_warp` simulations a warp: enough for one warp per
    `sims_per_warp` simulations, and at most `most`."""
    warps = -(-n_sims // sims_per_warp)
    return min(-(-warps // warps_per_block), most)


@functools.lru_cache(maxsize=None)
def blocks_per_sm(device_index: int, d: int, warps_per_block: int, season: bool) -> int:
    """How many blocks of `warps_per_block` warps of K1 (or K2, `season`)
    fit on one SM of the device at once for a field of d drivers: the CUDA
    occupancy calculator on the kernel's registers and shared memory."""
    if _lib is None:
        build()
    with torch.cuda.device(device_index):
        n = _lib.mcgp_blocks_per_sm(d, warps_per_block, int(season))
    if n < 0:
        raise RuntimeError(f"the occupancy query of the race kernel failed at {d} drivers")
    return n


def launch_shape(
    device, d: int, warps_per_block: int | None = None, season: bool = False
) -> tuple[int, int]:
    """(warps per block, blocks of a full launch) for a field of d drivers.

    The default block shape is the one of BLOCK_SHAPES that keeps the most
    warps on an SM at once: registers and the (d, d) shared histogram set
    that number per field width (the instance of `kernel_tier`). A full launch
    is GRID_WAVES whole waves of resident blocks, so no partial wave idles
    SMs at the end (the warps walk the simulations with a grid stride, so
    the grid only sets the balance, never the counts)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if warps_per_block is None:
        warps_per_block = max(
            BLOCK_SHAPES, key=lambda w: w * blocks_per_sm(index, d, w, season)
        )
    per_sm = blocks_per_sm(index, d, warps_per_block, season)
    if per_sm < 1:
        raise ValueError(
            f"a block of {warps_per_block} warps does not fit on an SM at {d} drivers"
        )
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    return warps_per_block, GRID_WAVES * n_sm * per_sm


def season_counts(
    pmat_s: torch.Tensor,
    scal_s: torch.Tensor,
    grid_log_s: torch.Tensor,
    race_laps,
    n_sims_per_race: int,
    seeds,
    sim_offset: int = 0,
    warps_per_block: int | None = None,
    blocks_per_race: int | None = None,
    fields=None,
) -> torch.Tensor:
    """(R, D, D) [race, driver, position] finish counts of a season: race r
    runs simulations [sim_offset, sim_offset + n_sims_per_race) of the
    Philox stream of `seeds[r]` over its own `race_laps[r]` laps, so it
    equals `race_counts(pmat_s[r], scal_s[r], grid_log_s[r], race_laps[r],
    n_sims_per_race, seeds[r], sim_offset)` bit for bit.

    CPU tensors run `season_counts_plain` (int64 counts). CUDA tensors run
    the whole season as one launch of the season kernel on the current
    stream (int32 counts); a launch error raises. The counts do not
    depend on `warps_per_block` or `blocks_per_race` (default: the block
    shape and grid of `launch_shape` for each race, so a season holds many
    more blocks than the SMs take at once, and the blocks of short races
    free their SMs for queued ones instead of leaving a ragged tail).
    `fields`, the races' own widths before padding (default D each), only
    feed the `race.cars` counter."""
    if pmat_s.device.type == "cpu":
        return season_counts_plain(
            pmat_s, scal_s, grid_log_s, race_laps, n_sims_per_race, seeds, sim_offset
        )
    if pmat_s.device.type != "cuda":
        raise ValueError(f"season_counts runs on cpu or cuda tensors, not {pmat_s.device}")
    n_races, d, laps, seeds = _check_season_inputs(
        pmat_s, scal_s, grid_log_s, race_laps, n_sims_per_race, seeds, sim_offset
    )
    _check_warps(warps_per_block)
    if n_races > 65535:
        raise ValueError(f"a season launch takes at most 65535 races, got {n_races}")
    dev = pmat_s.device
    counts = torch.zeros((n_races, d, d), dtype=torch.int32, device=dev)
    if n_sims_per_race == 0:
        return counts
    # the key words as uint32 bit patterns in int32, two per race
    key_words = [w - 2**32 if w >= 2**31 else w for s in seeds for w in philox.seed_key(s)]
    keys = torch.tensor(key_words, dtype=torch.int32, device=dev)
    laps_t = torch.tensor(laps, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        warps_per_block, full_grid = launch_shape(dev, d, warps_per_block, season=True)
        tier = library_tier(_lib, d)
        blocks_per_race = grid_blocks(n_sims_per_race, tier[1], warps_per_block,
                                      full_grid if blocks_per_race is None else blocks_per_race)
        if not 1 <= blocks_per_race <= 2**31 - 1:
            raise ValueError(f"blocks_per_race must be >= 1, got {blocks_per_race}")
        err = _lib.mcgp_season_counts(
            pmat_s.data_ptr(), scal_s.data_ptr(), grid_log_s.data_ptr(),
            laps_t.data_ptr(), keys.data_ptr(), counts.data_ptr(),
            n_races, d, sim_offset, n_sims_per_race, warps_per_block, blocks_per_race,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"season kernel launch failed: CUDA error {err}")
    season_counts.launches += 1
    _count_launch(tier, [d] * n_races if fields is None else fields, n_sims_per_race)
    return counts


season_counts.launches = 0


def _sharded_counts(
    launch, inputs: list[torch.Tensor], n_sims: int, mesh: Mesh, shape: tuple[int, ...]
) -> tuple[torch.Tensor, bool]:
    """(the `shape` counts of `n_sims` simulations split over `mesh` and the
    process group, on the first input's device; whether a kernel ran):
    `launch(*inputs on the shard's device, sim_offset, n)` runs one shard's
    range. Every shard is a device of the inputs' type (`local_shards`
    raises otherwise): CUDA inputs launch the kernel on every shard, CPU
    inputs run the plain version. Every shard is launched, each on its
    device's current stream, before any is waited for, so shards on several
    cards run at once; then the shards' counts are summed on the inputs'
    device and all-reduced across processes once, int32 on CUDA (as one
    launch gives) and int64 on the CPU."""
    home = inputs[0].device
    copies: dict[torch.device, list[torch.Tensor]] = {}
    parts = []
    for dev, lo, hi in local_shards(mesh, n_sims, home):
        if hi == lo:
            continue
        if dev not in copies:
            copies[dev] = [t.to(dev) for t in inputs]
        guard = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with guard:
            parts.append(launch(*copies[dev], lo, hi - lo))
    dtype = torch.int32 if home.type == "cuda" else torch.int64
    total = torch.zeros(shape, dtype=dtype, device=home)
    for part in parts:
        total += part.to(home)
    return distributed.all_reduce_counts(total), home.type == "cuda" and bool(parts)


def race_counts_sharded(
    pmat: torch.Tensor,
    scal: torch.Tensor,
    grid_log: torch.Tensor,
    race_laps: int,
    n_sims: int,
    seed: int = 0,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    """(D, D) counts of simulations [0, n_sims) of the stream of `seed`,
    split over `mesh` (default: every visible CUDA device for CUDA inputs,
    this process's own under a process group, or the CPU for CPU inputs;
    `parallel.mesh.resolve_mesh`) and the process group: the counterpart
    of the JAX package's sharded launch, `run_monte_carlo_pallas_sharded`
    (pallas_engine.py:1114). Shard i of W runs `race_counts` on its device
    for its own range (`parallel.mesh.shard_range`): K1 for CUDA inputs,
    the plain version for CPU inputs; a mesh with a shard of the other type
    raises. The JAX package pads the tile grid to a multiple of the device
    count and zeroes the pad tiles; here the ranges split any n exactly. The counts are bitwise those of one `race_counts`
    call for any mesh and any process count: the Philox counter is the
    global simulation index and integer sums are exact. Counts in
    `race_counts_sharded.launches` the calls that launched K1."""
    mesh = resolve_mesh(mesh, pmat.device)
    d = _check_inputs(pmat, scal, grid_log, race_laps, n_sims, 0)

    def launch(pmat, scal, grid_log, lo, n):
        return race_counts(pmat, scal, grid_log, race_laps, n, seed, sim_offset=lo)

    counts, launched = _sharded_counts(launch, [pmat, scal, grid_log], n_sims, mesh, (d, d))
    if launched:
        race_counts_sharded.launches += 1
    return counts


race_counts_sharded.launches = 0


def season_counts_sharded(
    pmat_s: torch.Tensor,
    scal_s: torch.Tensor,
    grid_log_s: torch.Tensor,
    race_laps,
    n_sims_per_race: int,
    seeds,
    mesh: Mesh | None = None,
    fields=None,
) -> torch.Tensor:
    """(R, D, D) counts of a season with every race's simulations split
    over `mesh` (default as in `race_counts_sharded`) and the process
    group: shard i runs its own range [lo, hi) of every race in one
    `season_counts` call on its device (K2 for CUDA inputs), and the
    (R, D, D) counts are summed and all-reduced once. The counterpart of the mesh branch of the JAX
    package's season launch (pallas_engine.py:962-983), which cuts its flat
    tile grid across race boundaries instead; cutting every race gives each
    shard 1/W of every race, and the counts are the same bit for bit: those
    of one `season_counts` call, for any mesh. Counts in
    `season_counts_sharded.launches` the calls that launched K2. `fields`
    as in `season_counts`."""
    mesh = resolve_mesh(mesh, pmat_s.device)
    n_races, d, laps, seeds = _check_season_inputs(
        pmat_s, scal_s, grid_log_s, race_laps, n_sims_per_race, seeds
    )

    def launch(pmat_s, scal_s, grid_log_s, lo, n):
        return season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds, sim_offset=lo,
                             fields=fields)

    counts, launched = _sharded_counts(
        launch, [pmat_s, scal_s, grid_log_s], n_sims_per_race, mesh, (n_races, d, d)
    )
    if launched:
        season_counts_sharded.launches += 1
    return counts


season_counts_sharded.launches = 0


def run_monte_carlo_season(
    params_list: list[SimParams],
    race_laps_list: list[int],
    season_seed: int,
    n_sims_per_race: int,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    """(R, D, D) float32 [race, driver, position] finish probabilities of a
    season on the params' device, D the widest field (narrower fields are
    padded; their real drivers finish in positions 1..d) — the counterpart
    of `monte_carlo_gp_tpu.ops.pallas_engine.run_monte_carlo_pallas_season`,
    with exactly `n_sims_per_race` simulations per race, split over `mesh`
    by `season_counts_sharded` (one season launch per shard; bitwise the
    same for any mesh).

    Race r is seeded with `philox.fold_in(season_seed, r)`, so it equals
    `run_monte_carlo_kernel` of race r's (padded) params at that seed."""
    if n_sims_per_race < 1:
        raise ValueError(f"n_sims_per_race must be >= 1, got {n_sims_per_race}")
    if len(race_laps_list) != len(params_list):
        raise ValueError("race_laps_list must match params_list")
    pmat_s, scal_s, grid_log_s, _ = pack_season_inputs(params_list)
    seeds = [philox.fold_in(season_seed, r) for r in range(len(params_list))]
    counts = season_counts_sharded(
        pmat_s, scal_s, grid_log_s, race_laps_list, n_sims_per_race, seeds, mesh,
        fields=[p.n_drivers for p in params_list],
    )
    return counts.to(torch.float32) / n_sims_per_race


def run_monte_carlo_kernel(
    params: SimParams, seed: int, n_sims: int, race_laps: int
) -> torch.Tensor:
    """(D, D) float32 [driver, position] finish probabilities of `n_sims`
    simulated races on the params' device — the counterpart of
    `monte_carlo_gp_tpu.ops.pallas_engine.run_monte_carlo_pallas`, with the
    lap count a runtime argument and exactly `n_sims` simulations."""
    if n_sims < 1:
        raise ValueError(f"n_sims must be >= 1, got {n_sims}")
    pmat, scal, grid_log = pack_inputs(params)
    counts = race_counts(pmat, scal, grid_log, race_laps, n_sims, seed)
    return counts.to(torch.float32) / n_sims


def run_monte_carlo_kernel_sharded(
    params: SimParams, seed: int, n_sims: int, race_laps: int, mesh: Mesh | None = None
) -> torch.Tensor:
    """`run_monte_carlo_kernel` with the simulations split over `mesh`
    (default as in `race_counts_sharded`) and the process group by
    `race_counts_sharded`: bitwise the same probabilities, on the params'
    device — the counterpart of
    `monte_carlo_gp_tpu.ops.pallas_engine.run_monte_carlo_pallas_sharded`."""
    if n_sims < 1:
        raise ValueError(f"n_sims must be >= 1, got {n_sims}")
    pmat, scal, grid_log = pack_inputs(params)
    counts = race_counts_sharded(pmat, scal, grid_log, race_laps, n_sims, seed, mesh)
    return counts.to(torch.float32) / n_sims
