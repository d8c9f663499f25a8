"""Central configuration: static F1 data tables and the simulation
parameters as a dataclass of tensors.

The tables are the same factual constants as `monte_carlo_gp_tpu.config`
(2025 driver→team map, per-team per-lap DNF rates, tire compounds, circuit
parameters, grid penalties, track-type taxonomy); `tests/test_torch_config.py`
holds them equal. `SimParams` carries every per-race simulation input as a
torch tensor on one device; `make_sim_params` validates host arrays once,
before anything reaches the race kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Static data tables
# ---------------------------------------------------------------------------

# 2025 season driver → team mapping.
DRIVER_TEAMS: dict[str, str] = {
    "VER": "Red Bull",
    "LAW": "Red Bull",
    "NOR": "McLaren",
    "PIA": "McLaren",
    "LEC": "Ferrari",
    "HAM": "Ferrari",
    "RUS": "Mercedes",
    "ANT": "Mercedes",
    "ALO": "Aston Martin",
    "STR": "Aston Martin",
    "GAS": "Alpine",
    "DOO": "Alpine",
    "TSU": "Racing Bulls",
    "HAD": "Racing Bulls",
    "ALB": "Williams",
    "SAI": "Williams",
    "HUL": "Sauber",
    "BOR": "Sauber",
    "OCO": "Haas",
    "BEA": "Haas",
}

# Per-lap DNF probability by team.
DEFAULT_DNF_RATES: dict[str, float] = {
    "Red Bull": 0.0015,
    "McLaren": 0.0012,
    "Ferrari": 0.0018,
    "Mercedes": 0.0010,
    "Aston Martin": 0.0020,
    "Alpine": 0.0025,
    "Racing Bulls": 0.0022,
    "Williams": 0.0025,
    "Sauber": 0.0028,
    "Haas": 0.0025,
}

# Tire compounds. Order defines the integer encoding used on the device:
# SOFT=0, MEDIUM=1, HARD=2, INTERMEDIATE=3, WET=4.
TIRE_COMPOUNDS: dict[str, dict[str, float]] = {
    "SOFT": {"pace_delta": -0.8, "deg_rate": 0.08, "optimal_laps": 15},
    "MEDIUM": {"pace_delta": 0.0, "deg_rate": 0.05, "optimal_laps": 25},
    "HARD": {"pace_delta": 0.6, "deg_rate": 0.03, "optimal_laps": 40},
    "INTERMEDIATE": {"pace_delta": 5.0, "deg_rate": 0.02, "optimal_laps": 30},
    "WET": {"pace_delta": 10.0, "deg_rate": 0.01, "optimal_laps": 50},
}

COMPOUND_NAMES: tuple[str, ...] = ("SOFT", "MEDIUM", "HARD", "INTERMEDIATE", "WET")
COMPOUND_IDS: dict[str, int] = {n: i for i, n in enumerate(COMPOUND_NAMES)}
SOFT, MEDIUM, HARD, INTERMEDIATE, WET = range(5)
N_COMPOUNDS = 5
# Bitmask of dry compounds for the mandatory two-dry-compound rule.
DRY_COMPOUND_MASK: int = (1 << SOFT) | (1 << MEDIUM) | (1 << HARD)

# Circuit parameters.
CIRCUITS: dict[str, dict[str, float]] = {
    "Bahrain": {"laps": 57, "pit_loss": 21.0, "drs_zones": 3, "overtake_delta": 0.6},
    "Saudi Arabia": {"laps": 50, "pit_loss": 20.0, "drs_zones": 3, "overtake_delta": 0.7},
    "Australia": {"laps": 58, "pit_loss": 22.0, "drs_zones": 4, "overtake_delta": 0.5},
    "Japan": {"laps": 53, "pit_loss": 23.0, "drs_zones": 1, "overtake_delta": 1.0},
    "China": {"laps": 56, "pit_loss": 22.0, "drs_zones": 2, "overtake_delta": 0.6},
    "Miami": {"laps": 57, "pit_loss": 21.0, "drs_zones": 3, "overtake_delta": 0.7},
    "Monaco": {"laps": 78, "pit_loss": 24.0, "drs_zones": 1, "overtake_delta": 1.5},
    "Canada": {"laps": 70, "pit_loss": 22.0, "drs_zones": 2, "overtake_delta": 0.6},
    "Spain": {"laps": 66, "pit_loss": 21.0, "drs_zones": 2, "overtake_delta": 0.8},
    "Austria": {"laps": 71, "pit_loss": 20.0, "drs_zones": 3, "overtake_delta": 0.5},
    "Great Britain": {"laps": 52, "pit_loss": 21.0, "drs_zones": 2, "overtake_delta": 0.7},
    "Hungary": {"laps": 70, "pit_loss": 22.0, "drs_zones": 1, "overtake_delta": 1.2},
    "Belgium": {"laps": 44, "pit_loss": 23.0, "drs_zones": 2, "overtake_delta": 0.5},
    "Netherlands": {"laps": 72, "pit_loss": 20.0, "drs_zones": 2, "overtake_delta": 1.0},
    "Italy": {"laps": 53, "pit_loss": 26.0, "drs_zones": 2, "overtake_delta": 0.4},
    "Azerbaijan": {"laps": 51, "pit_loss": 24.0, "drs_zones": 2, "overtake_delta": 0.5},
    "Singapore": {"laps": 62, "pit_loss": 30.0, "drs_zones": 3, "overtake_delta": 1.1},
    "United States": {"laps": 56, "pit_loss": 21.0, "drs_zones": 2, "overtake_delta": 0.7},
    "Mexico": {"laps": 71, "pit_loss": 22.0, "drs_zones": 3, "overtake_delta": 0.6},
    "Brazil": {"laps": 71, "pit_loss": 21.0, "drs_zones": 2, "overtake_delta": 0.5},
    "Las Vegas": {"laps": 50, "pit_loss": 21.0, "drs_zones": 2, "overtake_delta": 0.6},
    "Qatar": {"laps": 57, "pit_loss": 21.0, "drs_zones": 2, "overtake_delta": 0.8},
    "Abu Dhabi": {"laps": 58, "pit_loss": 22.0, "drs_zones": 2, "overtake_delta": 0.7},
}

# Grid penalty types in positions.
PENALTY_TYPES: dict[str, int] = {
    "engine": 10,
    "full_pu": 20,
    "gearbox": 5,
    "pitlane_start": 20,
}

# Track-type taxonomy for circuit-affinity similarity.
TRACK_TYPES: dict[str, str] = {
    "Monaco": "street",
    "Singapore": "street",
    "Azerbaijan": "street",
    "Las Vegas": "street",
    "Saudi Arabia": "street",
    "Italy": "high_speed",
    "Belgium": "high_speed",
    "Mexico": "high_speed",
    "Qatar": "high_speed",
    "Hungary": "technical",
    "Spain": "technical",
    "Netherlands": "technical",
    "Japan": "technical",
    "Bahrain": "balanced",
    "Abu Dhabi": "balanced",
    "Australia": "balanced",
    "China": "balanced",
    "Miami": "balanced",
    "Canada": "balanced",
    "Austria": "balanced",
    "Great Britain": "balanced",
    "United States": "balanced",
    "Brazil": "balanced",
}


def get_similar_tracks(track: str) -> list[str]:
    """Tracks sharing this track's type."""
    track_type = TRACK_TYPES.get(track, "balanced")
    return [t for t, tt in TRACK_TYPES.items() if tt == track_type and t != track]


# Fallback circuit parameters when a race is not in CIRCUITS.
DEFAULT_CIRCUIT: dict[str, float] = {
    "laps": 58,
    "pit_loss": 22.0,
    "drs_zones": 2,
    "overtake_delta": 0.8,
}

# Race-control event rates.
SC_PROBABILITY = 0.01
VSC_PROBABILITY = 0.015
RED_FLAG_PROBABILITY = 0.002
DRS_DELTA = 0.3

# Track-condition integer encoding used on the device.
DRY, DAMP, FULL_WET = 0, 1, 2
TRACK_CONDITIONS: dict[str, int] = {"dry": DRY, "damp": DAMP, "wet": FULL_WET}


# ---------------------------------------------------------------------------
# SimParams — per-race simulation inputs as tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SimParams:
    """All per-race simulation inputs as tensors on one device.

    Shapes use D = number of grid slots. Every field is float32 except
    `compound_optimal` and `track_condition` (int32) and `active` (bool).
    The lap count is not here: it is an argument of the race kernel.
    """

    # (D, D) [driver, position] qualifying position probabilities.
    grid_probs: torch.Tensor
    # (D,) per-driver base lap pace in seconds.
    base_pace: torch.Tensor
    # (D,) per-driver tire degradation rate.
    tire_deg: torch.Tensor
    # (D,) per-driver lap-time noise sigma.
    variance: torch.Tensor
    # (D,) resolved per-driver per-lap DNF rate.
    dnf_rate: torch.Tensor
    # (D,) team per-lap DNF rate; lap 1 uses it x4.
    team_dnf_rate: torch.Tensor
    # (5,) compound pace delta / deg rate / optimal stint length.
    compound_pace: torch.Tensor
    compound_deg: torch.Tensor
    compound_optimal: torch.Tensor
    # 0-d scalars.
    pit_loss: torch.Tensor
    overtake_delta: torch.Tensor
    drs_delta: torch.Tensor
    sc_prob: torch.Tensor
    vsc_prob: torch.Tensor
    red_flag_prob: torch.Tensor
    dirty_air_threshold: torch.Tensor
    dirty_air_penalty: torch.Tensor
    # int32 scalar: 0=dry, 1=damp, 2=wet.
    track_condition: torch.Tensor
    # (D,) bool — False marks padding slots beyond the real entry list.
    active: torch.Tensor

    @property
    def n_drivers(self) -> int:
        return self.grid_probs.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.grid_probs.device

    def to(self, device: str | torch.device) -> "SimParams":
        return SimParams(
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            }
        )


def pad_params(params: SimParams, d_max: int) -> SimParams:
    """`params` with its driver axis padded to `d_max` slots, the layout of
    a season's narrower fields (the season kernel's packing and the
    lap-engine season): padding slots are inactive (they start retired and
    classify after every real car), with zero pace, degradation, variance,
    DNF rates and grid probabilities."""
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


_FIELD_DTYPES = {
    "compound_optimal": torch.int32,
    "track_condition": torch.int32,
    "active": torch.bool,
}


def make_sim_params(
    *,
    grid_probs: np.ndarray,
    base_pace: np.ndarray,
    tire_deg: np.ndarray,
    variance: np.ndarray,
    dnf_rate: np.ndarray,
    team_dnf_rate: np.ndarray,
    pit_loss: float = 22.0,
    overtake_delta: float = 0.8,
    drs_delta: float = DRS_DELTA,
    sc_prob: float = SC_PROBABILITY,
    vsc_prob: float = VSC_PROBABILITY,
    red_flag_prob: float = RED_FLAG_PROBABILITY,
    dirty_air_threshold: float = 2.0,
    dirty_air_penalty: float = 0.5,
    track_condition: int | str = DRY,
    compound_table: dict[str, dict[str, float]] | None = None,
    active: np.ndarray | None = None,
    device: str | torch.device = "cpu",
) -> SimParams:
    """Build a `SimParams` from host arrays and scalars, on `device`."""
    compounds = compound_table or TIRE_COMPOUNDS
    cp = np.array([compounds[n]["pace_delta"] for n in COMPOUND_NAMES], np.float32)
    cd = np.array([compounds[n]["deg_rate"] for n in COMPOUND_NAMES], np.float32)
    co = np.array([compounds[n]["optimal_laps"] for n in COMPOUND_NAMES], np.int32)
    if isinstance(track_condition, str):
        track_condition = TRACK_CONDITIONS[track_condition]
    base_np = np.asarray(base_pace, float)
    d = base_np.shape[0]
    # The race kernel's rank keys are int32 views of cumulative times whose
    # injective domain ends at ~5e8 s (ops/race_kernel.rank_key); capping lap
    # pace at 15,000 s keeps any plausible race far inside it. A NaN pace
    # would map to an out-of-domain key and corrupt ranks silently, so
    # finiteness is checked too, here, while the values are on the host.
    if base_np.size:
        if not np.all(np.isfinite(base_np)):
            raise ValueError(
                "base_pace must be finite (a NaN/inf lap pace would corrupt "
                "the engines' bitcast rank keys)"
            )
        if float(base_np.max()) > 15_000.0:
            raise ValueError(
                f"base_pace up to {float(base_np.max()):.3g}s/lap exceeds "
                "the engines' rank-key domain (real lap times are ~60-120 s)"
            )
        if float(base_np.min()) < 0.0:
            raise ValueError(
                "base_pace must be non-negative (the fused kernel packs the "
                "DRS flag into the pace sign bit; a negative lap pace is "
                "physically meaningless anyway)"
            )
    deg_np = np.asarray(tire_deg, float)
    if deg_np.size and not np.all(np.isfinite(deg_np) & (deg_np >= 0.0)):
        raise ValueError(
            "tire_deg must be finite and non-negative (the reference "
            "clamps it to [0.01, 0.15], features.py:448-490; a negative "
            "or NaN rate would push overtake pace base_pace + age*deg "
            "outside the fused kernel's sign-packed domain and corrupt "
            "the bitcast rank keys)"
        )
    # Every other array that reaches the lap-time sum can smuggle the same
    # NaN into the cumulative time and corrupt the rank keys silently.
    for arr_name, arr in (
        ("variance", variance),
        ("dnf_rate", dnf_rate),
        ("team_dnf_rate", team_dnf_rate),
        ("grid_probs", grid_probs),
    ):
        a = np.asarray(arr, float)
        if a.size and not np.all(np.isfinite(a)):
            raise ValueError(
                f"{arr_name} must be finite (NaN/inf would corrupt the "
                "engines' lap times or grid sampling)"
            )
    if active is None:
        active = np.ones((d,), bool)
    return sim_params_from_numpy(
        {
            "grid_probs": grid_probs,
            "base_pace": base_pace,
            "tire_deg": tire_deg,
            "variance": variance,
            "dnf_rate": dnf_rate,
            "team_dnf_rate": team_dnf_rate,
            "compound_pace": cp,
            "compound_deg": cd,
            "compound_optimal": co,
            "pit_loss": pit_loss,
            "overtake_delta": overtake_delta,
            "drs_delta": drs_delta,
            "sc_prob": sc_prob,
            "vsc_prob": vsc_prob,
            "red_flag_prob": red_flag_prob,
            "dirty_air_threshold": dirty_air_threshold,
            "dirty_air_penalty": dirty_air_penalty,
            "track_condition": track_condition,
            "active": active,
        },
        device=device,
    )


def sim_params_from_numpy(
    fields: dict[str, np.ndarray], device: str | torch.device = "cpu"
) -> SimParams:
    """A `SimParams` from its fields as numpy arrays (or Python scalars),
    keyed by field name — the JAX package's `SimParams` fields carry over
    unchanged. Values are cast to the field's dtype (float32 unless noted
    on `SimParams`); no validation beyond that."""
    names = [f.name for f in dataclasses.fields(SimParams)]
    missing = sorted(set(names) - set(fields))
    if missing:
        raise ValueError(f"SimParams fields missing: {missing}")
    np_dtypes = {torch.int32: np.int32, torch.bool: np.bool_}
    out = {}
    for name in names:
        dtype = _FIELD_DTYPES.get(name, torch.float32)
        arr = np.asarray(fields[name], np_dtypes.get(dtype, np.float32))
        out[name] = torch.from_numpy(np.array(arr)).to(device)
    return SimParams(**out)


def circuit_info(race: str) -> dict[str, float]:
    """Circuit lookup with substring matching for FastF1 event names like
    'Bahrain Grand Prix'."""
    if race in CIRCUITS:
        return CIRCUITS[race]
    race_lower = race.lower()
    for name, info in CIRCUITS.items():
        if name.lower() in race_lower:
            return info
    return dict(DEFAULT_CIRCUIT)


def resolve_penalty(penalty: int | str) -> int:
    """Penalty type name → grid positions."""
    if isinstance(penalty, str):
        return PENALTY_TYPES.get(penalty, 0)
    return int(penalty)
