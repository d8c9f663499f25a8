"""The per-lap race engine: car state, lap 1, the lap step, classification —
the PyTorch port of `monte_carlo_gp_tpu/ops/lap_engine.py`.

This reimplements the behavioral contract of the reference's
`RaceSimulator.simulate_race` (reference simulation.py:147-560) as batched
tensor operations on whatever device the tensors are on:

  * car state is a dataclass of (n_sims, D) tensors,
  * every `if`/`for` in the reference becomes a masked `where`,
  * every `sorted()` becomes a rank computation (ops/ranking.py),
  * every `random.random()` becomes a batched Philox draw (`LapDraws`).

Event order per lap (matching simulation.py:164-228): race-control draws
(red flag -> SC -> VSC priority chain) -> dirty-air precompute -> per-car
{DNF draw, lap time, bookkeeping} -> pit stops -> overtake passes ->
position/DRS update.

Known, intentional divergences from the serial reference (the same as the
JAX package's; see tests/test_engine_stats.py):
  * tie-breaking in sorts uses the driver index instead of Python list order
    (ties between continuous lap times have probability zero),
  * the random stream differs (counter-based Philox vs one global stream),
    so equality with the reference is distributional, not bitwise,
  * the reference's `set.pop()` on a 2-element compound set (simulation.py
    :481-485) is replaced by a deterministic choice (HARD for long stints,
    MEDIUM otherwise); see PARITY.md divergence #1.

Random draws (`LapDraws`): the word of (simulation n, lap or grid slot t,
stream s, row r) is word `r & 3` of

    philox4x32_10(counter=(n, t, 0x4C415000 | s, r >> 2), key=seed_key(seed))

with n the global simulation index, so a draw depends on nothing but
(seed, n, t, s, r): not on how the simulations are split into blocks. Each
draw gives one uniform per row, (w >> 8) / 2**24. The streams, in the order
a race draws them:
  * grid slot p (p = 0..D-1): stream GRID at t = p, one row per driver;
  * lap 1: DNF, LAP_NOISE (a normal: streams LAP_NOISE and LAP_NOISE + 1 give
    Box-Muller's u1 and u2), START (a normal, streams START and START + 1);
  * each lap t = 2..race_laps: RACE_CONTROL (rows 0-3: red flag, SC, VSC,
    VSC refund), DNF, LAP_NOISE (a normal), OVERTAKE + pass for the three
    overtake passes, one row per position.
This is the engine's own stream, not the race kernel's (`ops/philox.py`).
"""

from __future__ import annotations

import dataclasses

import torch

from monte_carlo_gp_torch import config as cfg
from monte_carlo_gp_torch.config import SimParams
from monte_carlo_gp_torch.ops import philox
from monte_carlo_gp_torch.ops.ranking import (
    gather_at_rank,
    inverse_permutation,
    rank_by,
    rank_by_unique,
    scatter_by_rank,
    value_of_car_ahead,
)

INF_TIME = 1e30
FUEL_START = 110.0
FUEL_PER_LAP = 1.5
FUEL_PACE_GAIN = 0.03  # seconds per kg burned (simulation.py:327)
LAP_1_DNF_MULTIPLIER = 4.0  # simulation.py:282
SC_GAP = 0.5  # bunched gap per position under SC (simulation.py:360)
SC_LAPPED_SPACING = 90.0  # per-lap-down spacing estimate (simulation.py:367)
VSC_GAP_FACTOR = 0.8  # simulation.py:390
VSC_REFUND_PROB = 0.3  # simulation.py:393
RED_FLAG_GAP = 0.1  # standing-start interval (simulation.py:414)
OVERTAKE_PASSES = 3  # simulation.py:503
OVERTAKE_RESET_GAP = 0.3  # gap after a pass (simulation.py:527)
DRS_WINDOW = 1.0  # seconds to car ahead (simulation.py:558)

# draw streams (see the module docstring)
STREAM_GRID = 0
STREAM_DNF = 1
STREAM_LAP_NOISE = 2  # and 3
STREAM_START = 4  # and 5
STREAM_RACE_CONTROL = 6
STREAM_OVERTAKE = 7  # + pass: 7, 8, 9
_STREAM_TAG = 0x4C415000  # "LAP" in the third counter word
_RACE_CONTROL_ROWS = 4


class LapDraws:
    """The engine's random draws for simulations [sim_offset, sim_offset +
    n_sims) of the stream of `seed`: `uniform(t, stream, rows)` is the
    (n_sims, rows) float32 uniforms of draw (t, stream); `rows` defaults to
    the field's `n_rows`."""

    def __init__(
        self, seed: int, sim_offset: int, n_sims: int, n_rows: int,
        device: str | torch.device = "cpu",
    ):
        if n_sims and sim_offset + n_sims - 1 > 0xFFFFFFFF:
            raise ValueError("global simulation index exceeds 32 bits")
        self.key = philox.seed_key(seed)
        self.n_rows = n_rows
        self._sims = torch.arange(
            sim_offset, sim_offset + n_sims, dtype=torch.int64, device=device
        )[:, None]
        self._blocks = torch.arange(
            -(-max(n_rows, _RACE_CONTROL_ROWS) // 4), dtype=torch.int64, device=device
        )[None, :]
        self._zero = torch.zeros((), dtype=torch.int64, device=device)

    def bits(self, t: int, stream: int, rows: int | None = None) -> torch.Tensor:
        rows = self.n_rows if rows is None else rows
        blocks = self._blocks[:, : -(-rows // 4)]
        words = philox.philox4x32_10(
            (self._sims, self._zero + t, self._zero + (_STREAM_TAG | stream), blocks),
            self.key,
        )
        return torch.stack(words, -1).flatten(-2)[:, :rows]

    def uniform(self, t: int, stream: int, rows: int | None = None) -> torch.Tensor:
        return (self.bits(t, stream, rows) >> 8).to(torch.float32) * (1.0 / 16777216.0)

    def normal(self, t: int, stream: int) -> torch.Tensor:
        """Box-Muller from the uniforms of streams `stream` and `stream + 1`."""
        u1 = self.uniform(t, stream).clamp_min(5.9604645e-8)
        u2 = self.uniform(t, stream + 1)
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(6.2831853 * u2)


@dataclasses.dataclass(frozen=True)
class Cars:
    """Batched car state, all tensors (n_sims, D). Mirrors the reference's
    `CarState` dataclass (simulation.py:9-34) as a struct of arrays."""

    cum_time: torch.Tensor   # f32 cumulative race time
    last_lap: torch.Tensor   # f32 previous lap time (dirty-air input)
    tire_age: torch.Tensor   # i32 laps on current tires
    compound: torch.Tensor   # i32 compound id (config.COMPOUND_NAMES order)
    used_mask: torch.Tensor  # i32 bitmask of compounds used (2-compound rule)
    fuel: torch.Tensor       # f32 kg remaining
    pit_stops: torch.Tensor  # i32
    laps_done: torch.Tensor  # i32 laps_completed (SC lapped-car grouping)
    dnf: torch.Tensor        # bool retired
    dnf_lap: torch.Tensor    # i32 lap of retirement (classification key)
    drs: torch.Tensor        # bool DRS available this lap
    # NOT carried, as in the JAX package: the reference CarState's
    # `behind_leader` is recomputed as cum_time - current leader time at its
    # only consumer (the dirty-air precompute); `start_pos` is a lap-1 input,
    # passed to simulate_lap_1 directly.


def _condition_compound(track_condition: torch.Tensor, remaining: int) -> torch.Tensor:
    """Compound choice by condition + remaining laps, shared by pit stops and
    red-flag restarts (simulation.py:414-423 and :465-474)."""
    dry_pick = cfg.HARD if remaining > 30 else (cfg.MEDIUM if remaining > 15 else cfg.SOFT)
    return torch.where(
        track_condition == cfg.FULL_WET,
        cfg.WET,
        torch.where(track_condition == cfg.DAMP, cfg.INTERMEDIATE, dry_pick),
    ).to(torch.int32)


def _bit(compound: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(compound) << compound


def init_cars(params: SimParams, start_pos: torch.Tensor) -> Cars:
    """Starting state (reference `_initialize_cars`, simulation.py:244-273).

    Dry: top 10 start on 4-lap-old SOFTs (Q3 tires), rest on fresh MEDIUMs.
    Damp/wet: everyone on fresh INTERMEDIATE/WET.
    """
    top10 = start_pos < 10
    cond = params.track_condition
    dry_compound = torch.where(top10, cfg.SOFT, cfg.MEDIUM)
    compound = torch.where(
        cond == cfg.FULL_WET,
        cfg.WET,
        torch.where(cond == cfg.DAMP, cfg.INTERMEDIATE, dry_compound),
    ).to(torch.int32)
    tire_age = torch.where((cond == cfg.DRY) & top10, 4, 0).to(torch.int32)
    zeros_f = torch.zeros(start_pos.shape, dtype=torch.float32, device=start_pos.device)
    zeros_i = torch.zeros_like(zeros_f, dtype=torch.int32)
    return Cars(
        cum_time=zeros_f,
        last_lap=zeros_f,
        tire_age=tire_age,
        compound=compound,
        used_mask=_bit(compound),
        fuel=torch.full_like(zeros_f, FUEL_START),
        pit_stops=zeros_i,
        laps_done=zeros_i,
        dnf=torch.zeros_like(zeros_f, dtype=torch.bool),
        dnf_lap=zeros_i,
        drs=torch.zeros_like(zeros_f, dtype=torch.bool),
    )


def _clean_lap_time(params: SimParams, cars: Cars, noise: torch.Tensor) -> torch.Tensor:
    """Clean-air lap time (reference `_calculate_lap_time`, simulation.py:313-332).

    base + tire_age * (compound_deg * driver_deg/0.05) - burned_fuel*0.03
         + compound_pace_delta - DRS gain + N(0, sigma).
    """
    driver_factor = torch.where(params.tire_deg > 0, params.tire_deg / 0.05, 1.0)[None, :]
    compound = cars.compound.long()
    eff_deg = params.compound_deg[compound] * driver_factor
    tire_effect = cars.tire_age.to(torch.float32) * eff_deg
    fuel_effect = (FUEL_START - cars.fuel) * FUEL_PACE_GAIN
    compound_delta = params.compound_pace[compound]
    drs_gain = torch.where(cars.drs, params.drs_delta, 0.0)
    return (
        params.base_pace[None, :]
        + tire_effect
        - fuel_effect
        + compound_delta
        - drs_gain
        + params.variance[None, :] * noise
    )


def _active_rank(cars: Cars) -> torch.Tensor:
    """Rank among non-DNF cars by cumulative time; DNF cars rank last
    (ranking.rank_by_unique). Classification keeps the exact `rank_by`."""
    return rank_by_unique(cars.cum_time, cars.dnf)


def _update_positions(
    params: SimParams, cars: Cars, lap: int, drs_disabled: torch.Tensor
) -> tuple[Cars, torch.Tensor]:
    """End-of-lap position/DRS update (reference simulation.py:538-560).

    Also returns the active rank: nothing modifies cum_time/dnf between this
    update and the next lap's race-control step, so callers carry it
    forward instead of recomputing it."""
    rank = _active_rank(cars)
    gap_ahead = cars.cum_time - value_of_car_ahead(cars.cum_time, rank, fill=0.0)
    drs_ok = (
        (lap > 2)
        & ~drs_disabled[..., None]
        & (rank > 0)
        & (gap_ahead < DRS_WINDOW)
        & ~cars.dnf
    )
    return dataclasses.replace(cars, drs=drs_ok), rank


def simulate_lap_1(
    params: SimParams, cars: Cars, start_pos: torch.Tensor, rng: LapDraws
) -> tuple[Cars, torch.Tensor]:
    """Lap 1: 4x team-rate DNF risk, start-position-dependent position
    variance, no DRS (reference `_simulate_lap_1`, simulation.py:275-311).

    `start_pos` is the (n_sims, D) 0-indexed grid slot from grid sampling —
    a lap-1-only input, not part of the carried state."""
    u_dnf = rng.uniform(1, STREAM_DNF)
    # Respect pre-retired cars (padding slots beyond the real entry list).
    lap1_dnf = ~cars.dnf & (u_dnf < params.team_dnf_rate[None, :] * LAP_1_DNF_MULTIPLIER)

    noise = rng.normal(1, STREAM_LAP_NOISE)
    base_lap = _clean_lap_time(params, cars, noise)

    # Start model: sigma grows with grid slot; front-3 gains clamped.
    position = start_pos.to(torch.float32) + 1.0  # 1-indexed
    sigma = (0.5 + position * 0.1).clamp_max(1.5)
    start_delta = sigma * rng.normal(1, STREAM_START)
    start_delta = torch.where(position <= 3, start_delta.clamp_max(1.0), start_delta)
    lap_time = base_lap - start_delta * 0.5

    alive = ~cars.dnf & ~lap1_dnf
    cars = dataclasses.replace(
        cars,
        dnf=cars.dnf | lap1_dnf,
        dnf_lap=torch.where(lap1_dnf, 1, cars.dnf_lap),
        cum_time=torch.where(alive, cars.cum_time + lap_time, cars.cum_time),
        tire_age=torch.where(alive, cars.tire_age + 1, cars.tire_age),
        fuel=torch.where(alive, (cars.fuel - FUEL_PER_LAP).clamp_min(0.0), cars.fuel),
        # Note: the reference does NOT set last_lap_time or laps_completed on
        # lap 1 (simulation.py:298-305), so lap 2 never sees dirty air.
    )
    no_drs = torch.ones(cars.dnf.shape[:-1], dtype=torch.bool, device=cars.dnf.device)
    return _update_positions(params, cars, 1, no_drs)  # -> (cars, rank)


def lap_step(
    params: SimParams,
    total_laps: int,
    cars: Cars,
    drs_until: torch.Tensor,
    lap: int,
    rng: LapDraws,
    prev_rank: torch.Tensor | None = None,
) -> tuple[Cars, torch.Tensor, torch.Tensor]:
    """One racing lap (laps 2..total_laps), reference simulation.py:164-228.

    `drs_until` is the (n_sims,) int32 lap through which DRS stays
    disabled. `prev_rank` is the active rank from the previous position
    update (exact, since cum/dnf are untouched in between); recomputed when
    absent. Returns (cars, drs_until, rank-after-this-lap)."""
    lap = int(lap)

    # --- 1. Race control events (red -> SC -> VSC priority chain) ----------
    u = rng.uniform(lap, STREAM_RACE_CONTROL, _RACE_CONTROL_ROWS)
    is_red = u[:, 0] < params.red_flag_prob
    is_sc = ~is_red & (u[:, 1] < params.sc_prob)
    is_vsc = ~is_red & ~is_sc & (u[:, 2] < params.vsc_prob)

    rank = prev_rank if prev_rank is not None else _active_rank(cars)
    active = ~cars.dnf
    key_time = torch.where(cars.dnf, INF_TIME, cars.cum_time)
    leader_time = key_time.amin(-1, keepdim=True)
    leader_laps = torch.where((rank == 0) & active, cars.laps_done, 0).sum(-1, keepdim=True)
    rank_f = rank.to(torch.float32)
    laps_down = (leader_laps - cars.laps_done).to(torch.float32)
    sc_time = leader_time + rank_f * SC_GAP + torch.where(
        laps_down > 0, laps_down * SC_LAPPED_SPACING, 0.0
    )
    vsc_time = leader_time + (cars.cum_time - leader_time) * VSC_GAP_FACTOR
    vsc_refund = is_vsc & (u[:, 3] < VSC_REFUND_PROB)
    red_time = leader_time + rank_f * RED_FLAG_GAP

    m_red = is_red[:, None] & active
    m_sc = is_sc[:, None] & active
    m_vsc = is_vsc[:, None] & active

    cum_time = torch.where(
        m_red, red_time,
        torch.where(m_sc, sc_time, torch.where(m_vsc, vsc_time, cars.cum_time)),
    )
    age_refund = m_sc | (vsc_refund[:, None] & active)
    tire_age = torch.where(
        m_red, 0,
        torch.where(age_refund, (cars.tire_age - 1).clamp_min(0), cars.tire_age),
    )
    remaining = int(total_laps) - lap
    red_compound = _condition_compound(params.track_condition, remaining)
    compound = torch.where(m_red, red_compound, cars.compound)
    used_mask = torch.where(m_red, cars.used_mask | _bit(red_compound), cars.used_mask)

    drs_until = torch.where(
        is_red | is_sc, lap + 2, torch.where(is_vsc, lap + 1, drs_until)
    )
    cars = dataclasses.replace(
        cars, cum_time=cum_time, tire_age=tire_age, compound=compound, used_mask=used_mask,
    )

    # --- 2. Dirty-air precompute (simulation.py:179-183) -------------------
    # `rank` is still the current standings: the event rewrites above are
    # monotone in rank among active cars (SC: leader + rank*0.5; VSC: gaps
    # scaled 0.8; red: leader + rank*0.1) and dnf is untouched (the JAX
    # package's lap_engine.py:302-315 discusses the quantized-key corner).
    ahead_last_lap = value_of_car_ahead(cars.last_lap, rank, fill=0.0)

    # --- 3. Per-car DNF draw + lap time (simulation.py:186-228) ------------
    u_dnf = rng.uniform(lap, STREAM_DNF)
    new_dnf = active & (u_dnf < params.dnf_rate[None, :])
    alive = active & ~new_dnf

    noise = rng.normal(lap, STREAM_LAP_NOISE)
    clean = _clean_lap_time(params, cars, noise)
    # behind_leader, recomputed (see the Cars docstring): the race-control
    # rewrites preserve the leader, so `leader_time` from step 1 is still the
    # leader's cum, and for every live car cum - leader equals the value the
    # reference carries.
    behind = cars.cum_time - leader_time
    in_dirty_air = (
        (behind > 0) & (ahead_last_lap > 0) & (behind < params.dirty_air_threshold)
    )
    lap_time = torch.where(
        in_dirty_air, torch.maximum(clean + params.dirty_air_penalty, ahead_last_lap), clean
    )

    cars = dataclasses.replace(
        cars,
        dnf=cars.dnf | new_dnf,
        dnf_lap=torch.where(new_dnf, lap, cars.dnf_lap),
        cum_time=torch.where(alive, cars.cum_time + lap_time, cars.cum_time),
        last_lap=torch.where(alive, lap_time, cars.last_lap),
        tire_age=torch.where(alive, cars.tire_age + 1, cars.tire_age),
        fuel=torch.where(alive, (cars.fuel - FUEL_PER_LAP).clamp_min(0.0), cars.fuel),
        laps_done=torch.where(alive, cars.laps_done + 1, cars.laps_done),
    )

    # --- 4. Pit stops (simulation.py:433-494) -------------------------------
    cars = _pit_stops(params, cars, remaining)

    # --- 5. Overtake passes (simulation.py:496-536) -------------------------
    cars = _overtakes(params, cars, rng, lap)

    # --- 6. Position / DRS update (simulation.py:538-560) -------------------
    drs_disabled = lap <= drs_until
    cars, rank_out = _update_positions(params, cars, lap, drs_disabled)
    return cars, drs_until, rank_out


def _pit_stops(params: SimParams, cars: Cars, remaining: int) -> Cars:
    """Pit when tire age exceeds the (driver-deg adjusted) optimal stint and
    more than 5 laps remain; enforce the mandatory two-dry-compound rule
    (reference `_handle_pit_stops`, simulation.py:433-494)."""
    opt = params.compound_optimal[cars.compound.long()].to(torch.float32)
    deg = params.tire_deg[None, :]
    # int() truncation in the reference == floor for positive values.
    opt_adj = torch.where(
        deg > 0.05,
        torch.floor(opt * 0.85),
        torch.where(deg < 0.02, torch.floor(opt * 1.1), opt),
    ).to(torch.int32)
    pit = ~cars.dnf & (cars.tire_age > opt_adj) & (remaining > 5)

    new_compound = _condition_compound(params.track_condition, remaining)

    # Two-compound rule: if exactly one dry compound used so far and the pick
    # repeats it (and conditions are dry), pick a different one.
    used_dry = cars.used_mask & cfg.DRY_COMPOUND_MASK
    n_used_dry = (
        ((used_dry >> cfg.SOFT) & 1) + ((used_dry >> cfg.MEDIUM) & 1) + ((used_dry >> cfg.HARD) & 1)
    )
    is_wet_cond = params.track_condition != cfg.DRY
    must_switch = (n_used_dry == 1) & (((used_dry >> new_compound) & 1) == 1) & ~is_wet_cond
    # Deterministic resolution of the reference's set.pop(): long stints
    # prefer MEDIUM then HARD; short stints prefer SOFT then MEDIUM.
    if remaining > 20:
        alt = torch.where(((used_dry >> cfg.MEDIUM) & 1) == 0, cfg.MEDIUM, cfg.HARD)
    else:
        alt = torch.where(((used_dry >> cfg.SOFT) & 1) == 0, cfg.SOFT, cfg.MEDIUM)
    new_compound = torch.where(must_switch, alt, new_compound).to(torch.int32)

    return dataclasses.replace(
        cars,
        cum_time=torch.where(pit, cars.cum_time + params.pit_loss, cars.cum_time),
        compound=torch.where(pit, new_compound, cars.compound),
        used_mask=torch.where(pit, cars.used_mask | _bit(new_compound), cars.used_mask),
        tire_age=torch.where(pit, 0, cars.tire_age),
        pit_stops=torch.where(pit, cars.pit_stops + 1, cars.pit_stops),
    )


def _overtakes(params: SimParams, cars: Cars, rng: LapDraws, lap: int) -> Cars:
    """Up to 3 cascade passes over adjacent time-sorted pairs
    (reference `_simulate_overtakes`, simulation.py:496-536).

    Within a pass, the reference's attempt/success decisions are independent
    of the in-pass time rewrites (eligibility and probability depend only on
    pace, tire age and DRS, all fixed during the pass), so all pair decisions
    are evaluated in parallel and the sequential time-rewrite chain is then
    replayed position by position. The reference stops early when a pass
    produces no overtake — replicated per simulation with a gating flag, so
    later passes change nothing.
    """
    d = cars.cum_time.shape[-1]
    pace = params.base_pace[None, :] + cars.tire_age.to(torch.float32) * params.tire_deg[None, :]

    # DNF gating folds into poisoned pace/bonus values: a -1e30 "ahead" pace
    # makes any pair behind a DNF car ineligible, and a -3e30 DRS bonus makes
    # a DNF attacker ineligible even after the +1e30 from its own poisoned
    # pace cancels in. For live pairs both are the original values and
    # `delta` keeps the op order (ahead - pace + bonus).
    pace_p = torch.where(cars.dnf, -1e30, pace)
    bonus_p = torch.where(
        cars.dnf, -3e30, torch.where(cars.drs, params.drs_delta, 0.0)
    )

    behind_car = (torch.arange(d, device=pace.device) > 0)[None, :]
    pass_active = torch.ones(cars.cum_time.shape[:-1], dtype=torch.bool, device=pace.device)
    cum = cars.cum_time
    for p in range(OVERTAKE_PASSES):
        # Reference sorts ALL cars (including DNF) by cumulative time.
        rank = rank_by_unique(cum)
        cum_pos = scatter_by_rank(cum, rank)
        pace_pos = scatter_by_rank(pace_p, rank)
        bonus_pos = scatter_by_rank(bonus_p, rank)

        # delta = pace_ahead - pace_behind (+ DRS boost for the car behind);
        # indexed by the BEHIND car's position 1..D-1.
        ahead_pace = torch.cat([pace_pos[..., :1], pace_pos[..., :-1]], dim=-1)
        delta = ahead_pace - pace_pos + bonus_pos
        eligible = behind_car & (delta > params.overtake_delta)
        prob = (delta / 2.0).clamp_max(0.5)
        u = rng.uniform(lap, STREAM_OVERTAKE + p)
        swap = eligible & (u < prob) & pass_active[..., None]

        # Sequential time-rewrite chain (exact reference semantics given the
        # same decisions): new_behind = max(0.1, current_ahead - 0.1);
        # ahead becomes new_behind + 0.3.
        cols = list(cum_pos.unbind(-1))
        for i in range(1, d):
            sw = swap[..., i]
            nb = (cols[i - 1] - 0.1).clamp_min(0.1)
            cols[i - 1] = torch.where(sw, nb + OVERTAKE_RESET_GAP, cols[i - 1])
            cols[i] = torch.where(sw, nb, cols[i])
        cum = gather_at_rank(torch.stack(cols, dim=-1), rank)
        pass_active = pass_active & swap.any(-1)

    return dataclasses.replace(cars, cum_time=cum)


def classify(cars: Cars) -> torch.Tensor:
    """Final 1-indexed positions (reference simulation.py:230-242):
    finishers by cumulative time, then DNFs by (retirement lap, cumulative
    time) descending, ties by driver index. Runs once per race, so it keeps
    the EXACT (value, index)-lexicographic rank rather than the quantized
    keys used per lap. The JAX package counts the DNF order pairwise; here
    three stable sorts give it (least significant key first)."""
    active_rank = rank_by(torch.where(cars.dnf, INF_TIME, cars.cum_time))
    n_active = (~cars.dnf).sum(-1, keepdim=True, dtype=torch.int32)

    order = torch.argsort(-cars.cum_time, dim=-1, stable=True)
    for key in (-cars.dnf_lap, (~cars.dnf).to(torch.uint8)):
        order = order.gather(-1, torch.argsort(key.gather(-1, order), dim=-1, stable=True))
    # DNF cars sort first, so a DNF car's place here is its DNF rank
    dnf_rank = inverse_permutation(order).to(torch.int32)

    return torch.where(cars.dnf, n_active + dnf_rank, active_rank) + 1
