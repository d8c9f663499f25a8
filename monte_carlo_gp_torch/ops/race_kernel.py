"""The whole-race Monte Carlo: each simulation runs one full race (grid,
lap 1, laps 2..race_laps, classification) and adds its finishing order to a
(D, D) [driver, position] histogram.

`race_counts` is the entry point for one race, `season_counts` for a
season of races in one launch. For CPU tensors they run `race_counts_plain`
and `season_counts_plain`, the plain PyTorch versions; for CUDA tensors
they launch the hand-written kernels in `csrc/race_kernel.cu` (one warp per
simulation, one car per lane, one race body for both), or raise. Both follow the Pallas kernel
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

import ctypes
import dataclasses

import torch

from monte_carlo_gp_torch import config as cfg
from monte_carlo_gp_torch.config import SimParams
from monte_carlo_gp_torch.ops import philox

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

# The CUDA kernel keeps one car per lane of a warp.
MAX_CUDA_DRIVERS = 32
# The plain version's rank keys pack (quantized time) * M + row; M = 128
# bounds the field (the same limit as the Pallas kernel).
MAX_DRIVERS = 128
DEFAULT_WARPS_PER_BLOCK = 8

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


def _pad_params(params: SimParams, d_max: int) -> SimParams:
    """`params` with its driver axis padded to `d_max` slots: padding slots
    are inactive, with zero pace, degradation, variance, DNF rates and grid
    probabilities."""
    extra = d_max - params.n_drivers
    if extra == 0:
        return params

    def pad1(t):
        return torch.nn.functional.pad(t, (0, extra))

    return dataclasses.replace(
        params,
        grid_probs=torch.nn.functional.pad(params.grid_probs, (0, extra, 0, extra)),
        base_pace=pad1(params.base_pace),
        tire_deg=pad1(params.tire_deg),
        variance=pad1(params.variance),
        dnf_rate=pad1(params.dnf_rate),
        team_dnf_rate=pad1(params.team_dnf_rate),
        active=pad1(params.active),
    )


def pack_season_inputs(
    params_list: list[SimParams],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """(pmat_s (R, D, 8), scal_s (R, 24), grid_log_s (R, D, D), D) for a
    season of R races on their params' device, D the widest field. Narrower
    fields are padded as `monte_carlo_gp_tpu.parallel.sharded.stack_params`
    pads them: padding slots are inactive (they start retired and classify
    after every real car), with zero pace, degradation, variance and DNF
    rates and zero grid probabilities (-1e30 in grid_log)."""
    if not params_list:
        raise ValueError("a season needs at least one race")
    d_max = max(p.n_drivers for p in params_list)
    packed = [pack_inputs(_pad_params(p, d_max)) for p in params_list]
    pmat_s, scal_s, grid_log_s = (torch.stack(parts).contiguous() for parts in zip(*packed))
    return pmat_s, scal_s, grid_log_s, d_max


def _rank_tier(d: int) -> tuple[int, int]:
    """(Q, M) of the rank key: quantize time to 2**Q units in the last
    place, leave room for M rows."""
    return (2, 32) if d <= 32 else ((3, 64) if d <= 64 else (4, 128))


_IKEY_BASE = 0x3E800000  # the int32 view of 0.25f


def rank_key(cum, row, q_shift, row_mult, dnf=None):
    """Unique int32 keys ordered by (cum quantized to 2**Q ULP, row): exact
    cumulative-time ties are real and must break by row index. DNF cars
    sort last with distinct sentinels."""
    ikey = cum.clamp_min(0.25).view(torch.int32)
    ikey = ((ikey - _IKEY_BASE) >> q_shift) * row_mult + row
    if dnf is None:
        return ikey
    return torch.where(dnf, 2_100_000_000 + row, ikey)


def _ranks(key):
    """(rank, order) over the driver axis for UNIQUE keys: rank_i =
    #{j: k_j < k_i} and order[p] = the row of rank p. A sort gives the same
    ranks as the Pallas kernel's pairwise count because no two keys tie."""
    order = torch.argsort(key, dim=1)
    iota = torch.arange(key.shape[1], device=key.device).expand_as(order)
    return torch.empty_like(order).scatter_(1, order, iota), order


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


def _simulate(pmat, scal, grid_log, race_laps: int, bits, n: int):
    """One chunk of `n` simulations -> final positions (n, D), 1-based."""
    dev = pmat.device
    d = pmat.shape[0]
    f32, i32 = torch.float32, torch.int32
    q_shift, row_mult = _rank_tier(d)
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

        # overtakes: 3 passes in position space. Row p of r_* is the car at
        # position p; the reference's sequential time-rewrite chain
        #   nb = max(0.1, rows[p-1] - 0.1); if swap[p]: rows[p-1] = nb + 0.3; rows[p] = nb
        # is evaluated in the Pallas kernel's closed form, a prefix max of
        # z = where(swapped, -inf, r_cum + 0.1 p) (the two differ by ULPs).
        pace = torch.where(dnf, float("nan"), base_pace + age * driver_deg)
        att = pace - torch.where(drs, drs_delta, 0.0)
        pass_active = torch.ones((n, 1), dtype=torch.bool, device=dev)
        for _ in range(3 if d > 1 else 0):
            orank, inv = _ranks(key_of(cum))
            r_cum, r_pace, r_att = (x.gather(1, inv) for x in (cum, pace, att))
            delta = r_pace[:, :-1] - r_att[:, 1:]
            prob = (delta * 0.5).clamp_max(0.5)
            u = uniform()
            swap = (delta > overtake_delta) & (u[:, 1:] < prob) & pass_active
            no_swap = torch.zeros((n, 1), dtype=torch.bool, device=dev)
            swapped = torch.cat([no_swap, swap], 1)
            z = torch.where(swapped, -INF, r_cum + tenth)
            dist = 1
            while dist < d:
                shifted = torch.cat(
                    [torch.full((n, dist), -INF, dtype=f32, device=dev), z[:, : d - dist]], 1
                )
                z = torch.maximum(z, shifted)
                dist *= 2
            a = torch.where(swapped, (z - tenth).clamp_min(0.1), r_cum)
            swap_next = torch.cat([swapped[:, 1:], no_swap], 1)
            final = torch.where(swap_next, (a - 0.1).clamp_min(0.1) + 0.3, a)
            cum = final.gather(1, orank)
            pass_active = pass_active & swap.any(1, keepdim=True)

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


def _check_inputs(pmat, scal, grid_log, race_laps, n_sims, sim_offset, max_d):
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
    if not 1 <= d <= max_d:
        raise ValueError(
            f"{d} drivers: this path takes 1..{max_d} (the plain version's rank "
            f"keys pack *{MAX_DRIVERS}+row; the CUDA kernels keep one car per lane, "
            f"and fields of {MAX_CUDA_DRIVERS + 1}..{MAX_DRIVERS} drivers on CUDA "
            "are ROADMAP B-1b)"
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
    d = _check_inputs(pmat, scal, grid_log, race_laps, n_sims, sim_offset, MAX_DRIVERS)
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


def _check_season_inputs(pmat_s, scal_s, grid_log_s, race_laps, n_sims, seeds, max_d):
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
        d = _check_inputs(pmat_s[r], scal_s[r], grid_log_s[r], laps[r], n_sims, 0, max_d)
        philox.seed_key(seeds[r])
    return n_races, d, laps, seeds


def season_counts_plain(
    pmat_s: torch.Tensor,
    scal_s: torch.Tensor,
    grid_log_s: torch.Tensor,
    race_laps,
    n_sims_per_race: int,
    seeds,
    bits=None,
) -> torch.Tensor:
    """The plain PyTorch version of the season kernel, on pmat_s's device:
    (R, D, D) int64 counts, race r being `race_counts_plain` of race r's
    inputs, its own lap count `race_laps[r]` and simulations
    0..n_sims_per_race-1 of the stream of `seeds[r]` (or of `bits`, the same
    bit source for every race)."""
    n_races, _, laps, seeds = _check_season_inputs(
        pmat_s, scal_s, grid_log_s, race_laps, n_sims_per_race, seeds, MAX_DRIVERS
    )
    return torch.stack([
        race_counts_plain(
            pmat_s[r], scal_s[r], grid_log_s[r], laps[r], n_sims_per_race, seeds[r],
            bits=bits,
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
            ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return path


def race_counts(
    pmat: torch.Tensor,
    scal: torch.Tensor,
    grid_log: torch.Tensor,
    race_laps: int,
    n_sims: int,
    seed: int = 0,
    sim_offset: int = 0,
    warps_per_block: int = DEFAULT_WARPS_PER_BLOCK,
) -> torch.Tensor:
    """(D, D) [driver, position] finish counts of simulations
    [sim_offset, sim_offset + n_sims) of the Philox stream of `seed`.

    CPU tensors run `race_counts_plain` (int64 counts). CUDA tensors launch
    the CUDA kernel on the current stream (int32 counts; D <= 32); a launch
    error raises. The counts do not depend on `warps_per_block`."""
    if pmat.device.type == "cpu":
        return race_counts_plain(pmat, scal, grid_log, race_laps, n_sims, seed, sim_offset)
    if pmat.device.type != "cuda":
        raise ValueError(f"race_counts runs on cpu or cuda tensors, not {pmat.device}")
    d = _check_inputs(
        pmat, scal, grid_log, race_laps, n_sims, sim_offset, MAX_CUDA_DRIVERS
    )
    if not 1 <= warps_per_block <= 32:
        raise ValueError(f"warps_per_block must be in 1..32, got {warps_per_block}")
    key0, key1 = philox.seed_key(seed)
    counts = torch.zeros((d, d), dtype=torch.int32, device=pmat.device)
    if n_sims == 0:
        return counts
    if _lib is None:
        build()
    with torch.cuda.device(pmat.device):
        n_blocks = min(-(-n_sims // warps_per_block), _grid_blocks(pmat.device, warps_per_block))
        err = _lib.mcgp_race_counts(
            pmat.data_ptr(), scal.data_ptr(), grid_log.data_ptr(), counts.data_ptr(),
            d, int(race_laps), key0, key1, sim_offset, n_sims,
            warps_per_block, n_blocks, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"race kernel launch failed: CUDA error {err}")
    race_counts.launches += 1
    return counts


race_counts.launches = 0


def _grid_blocks(device, warps_per_block: int) -> int:
    """Blocks of a full launch: 64 warps per SM's worth, so every SM holds
    as many blocks as fit at once and the rest queue behind them."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return n_sm * max(1, 64 // warps_per_block)


def season_counts(
    pmat_s: torch.Tensor,
    scal_s: torch.Tensor,
    grid_log_s: torch.Tensor,
    race_laps,
    n_sims_per_race: int,
    seeds,
    warps_per_block: int = DEFAULT_WARPS_PER_BLOCK,
    blocks_per_race: int | None = None,
) -> torch.Tensor:
    """(R, D, D) [race, driver, position] finish counts of a season: race r
    runs simulations 0..n_sims_per_race-1 of the Philox stream of
    `seeds[r]` over its own `race_laps[r]` laps, so it equals
    `race_counts(pmat_s[r], scal_s[r], grid_log_s[r], race_laps[r],
    n_sims_per_race, seeds[r])` bit for bit.

    CPU tensors run `season_counts_plain` (int64 counts). CUDA tensors run
    the whole season as one launch of the season kernel on the current
    stream (int32 counts; D <= 32); a launch error raises. The counts do not
    depend on `warps_per_block` or `blocks_per_race` (default: each race
    gets the single-race launch's grid, so a season holds many more blocks
    than the SMs take at once, and the blocks of short races free their
    SMs for queued ones instead of leaving a ragged tail)."""
    if pmat_s.device.type == "cpu":
        return season_counts_plain(
            pmat_s, scal_s, grid_log_s, race_laps, n_sims_per_race, seeds
        )
    if pmat_s.device.type != "cuda":
        raise ValueError(f"season_counts runs on cpu or cuda tensors, not {pmat_s.device}")
    n_races, d, laps, seeds = _check_season_inputs(
        pmat_s, scal_s, grid_log_s, race_laps, n_sims_per_race, seeds, MAX_CUDA_DRIVERS
    )
    if not 1 <= warps_per_block <= 32:
        raise ValueError(f"warps_per_block must be in 1..32, got {warps_per_block}")
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
    if _lib is None:
        build()
    with torch.cuda.device(dev):
        if blocks_per_race is None:
            blocks_per_race = _grid_blocks(dev, warps_per_block)
        blocks_per_race = min(blocks_per_race, -(-n_sims_per_race // warps_per_block))
        if not 1 <= blocks_per_race <= 2**31 - 1:
            raise ValueError(f"blocks_per_race must be >= 1, got {blocks_per_race}")
        err = _lib.mcgp_season_counts(
            pmat_s.data_ptr(), scal_s.data_ptr(), grid_log_s.data_ptr(),
            laps_t.data_ptr(), keys.data_ptr(), counts.data_ptr(),
            n_races, d, n_sims_per_race, warps_per_block, blocks_per_race,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"season kernel launch failed: CUDA error {err}")
    season_counts.launches += 1
    return counts


season_counts.launches = 0


def run_monte_carlo_season(
    params_list: list[SimParams],
    race_laps_list: list[int],
    season_seed: int,
    n_sims_per_race: int,
) -> torch.Tensor:
    """(R, D, D) float32 [race, driver, position] finish probabilities of a
    season on the params' device, D the widest field (narrower fields are
    padded; their real drivers finish in positions 1..d) — the counterpart
    of `monte_carlo_gp_tpu.ops.pallas_engine.run_monte_carlo_pallas_season`,
    with exactly `n_sims_per_race` simulations per race.

    Race r is seeded with `philox.fold_in(season_seed, r)`, so it equals
    `run_monte_carlo_kernel` of race r's (padded) params at that seed."""
    if n_sims_per_race < 1:
        raise ValueError(f"n_sims_per_race must be >= 1, got {n_sims_per_race}")
    if len(race_laps_list) != len(params_list):
        raise ValueError("race_laps_list must match params_list")
    pmat_s, scal_s, grid_log_s, _ = pack_season_inputs(params_list)
    seeds = [philox.fold_in(season_seed, r) for r in range(len(params_list))]
    counts = season_counts(pmat_s, scal_s, grid_log_s, race_laps_list, n_sims_per_race, seeds)
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
