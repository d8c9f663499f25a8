"""The plain race simulation: a frozen copy of the plain PyTorch version of
the port's race kernel (`monte_carlo_gp_torch/ops/race_kernel.py`:
`pack_inputs`, `_simulate`, `race_counts_plain` and their helpers, with
`philox.py` and `ranking.py` beside it) as the port had it when the
benchmark was written. It draws the kernels' Philox stream, so on the same
inputs its counts and the kernels' agree up to the last bits of `log` and
`cos`.

`lowp=True` is the control of the correctness check: the inputs, every lap
time and every cumulative race time rounded to bfloat16 (the precision below
the configuration's float32), all else as the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import config as cfg
from perfbench.reference.config import SimParams
from perfbench.reference import philox
from perfbench.reference.ranking import inverse_permutation, rank_key, rank_tier


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to bfloat16 and back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


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


def _simulate(pmat, scal, grid_log, race_laps: int, bits, n: int, lowp: bool = False):
    """One chunk of `n` simulations -> final positions (n, D), 1-based."""
    rnd = _bf16 if lowp else (lambda x: x)
    pmat, scal, grid_log = rnd(pmat), rnd(scal), rnd(grid_log)
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
    lap_time = rnd(base_lap - start_delta * 0.5)
    alive = ~dnf & ~lap1_dnf
    dnf = dnf | lap1_dnf
    dnf_lap = torch.where(lap1_dnf, 1.0, dnf_lap)
    cum = rnd(torch.where(alive, cum + lap_time, cum))
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
        lap_time = rnd(lap_time)
        cum = rnd(torch.where(alive, cum + lap_time, cum))
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
    lowp: bool = False,
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
        pos = _simulate(pmat, scal, grid_log, int(race_laps), src, n, lowp)
        counts += torch.bincount((row * d + pos - 1).flatten(), minlength=d * d)
    return counts.view(d, d)



def finish_probs(params: SimParams, laps: int, n_sims: int, seed: int, device,
                 lowp: bool = False) -> np.ndarray:
    """(D, D) float32 finish-position probabilities of `n_sims` races of
    `params` on `device` from the Philox stream of `seed`, on the host: the
    counts over n_sims, as the port's wrappers return them."""
    pmat, scal, grid_log = pack_inputs(params.to(device))
    counts = race_counts_plain(pmat, scal, grid_log, laps, n_sims, seed, lowp=lowp)
    return (counts.to(torch.float32) / n_sims).cpu().numpy()
