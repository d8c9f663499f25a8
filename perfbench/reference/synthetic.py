"""Deterministic synthetic F1 season generator.

Serves three roles:
  * the offline test fixture dataset (SURVEY.md §4 — no test touches the
    network),
  * a demo/benchmark data source in environments without FastF1,
  * a ground-truth world with known driver skills for end-to-end validation
    (backtest Brier scores against a world where the "right answer" is known).

All data is generated from a counter-based numpy Generator keyed by
(seed, season, event, session), so any slice is reproducible in isolation.
Frames use the normalized schema shared with the FastF1 backend: lap times
in float seconds, FastF1-compatible column names (Driver, Team, LapTime,
LapNumber, Sector1Time..3, Compound, IsAccurate, PitInTime, PitOutTime,
TrackTemp, Rainfall, Position).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from perfbench.reference import config as cfg

# A stable subset of circuits forming the synthetic calendar.
CALENDAR: tuple[str, ...] = (
    "Bahrain",
    "Saudi Arabia",
    "Australia",
    "Japan",
    "China",
    "Miami",
    "Monaco",
    "Spain",
    "Austria",
    "Great Britain",
    "Hungary",
    "Belgium",
    "Italy",
    "Singapore",
    "United States",
    "Mexico",
    "Brazil",
    "Las Vegas",
    "Qatar",
    "Abu Dhabi",
)
SPRINT_EVENTS: tuple[str, ...] = ("China", "Miami", "Belgium", "United States", "Brazil", "Qatar")
WET_EVENTS: tuple[str, ...] = ("Belgium", "Brazil")  # rainfall in these rounds

_SESSION_IDS = {"FP1": 1, "FP2": 2, "FP3": 3, "Q": 4, "SQ": 5, "S": 6, "R": 7}


class SyntheticBackend:
    """Session backend producing deterministic plausible seasons."""

    name = "synthetic"
    # Fabricates data locally — no network — so offline=True loaders may
    # still use it (loader._backend_allowed).
    offline_safe = True

    def __init__(self, seed: int = 2718, n_events: int | None = None):
        self.seed = seed
        self.n_events = n_events or len(CALENDAR)
        self.drivers = list(cfg.DRIVER_TEAMS.keys())
        # Per-driver latent skills, fixed across seasons (plus season drift).
        root = np.random.default_rng(seed)
        self._base_skill = root.normal(0.0, 0.45, len(self.drivers))
        # dict.fromkeys, NOT set(): the per-team draws are consumed in
        # iteration order, and a string set's order is hash-randomized —
        # with set() the whole synthetic world permuted its team pace per
        # process (PYTHONHASHSEED), which made every statistical gate on
        # synthetic data a different random realization per pytest run.
        self._team_pace = {
            team: root.normal(0.0, 0.35)
            for team in dict.fromkeys(cfg.DRIVER_TEAMS.values())
        }

    # -- deterministic sub-generators ---------------------------------------

    def _rng(self, season: int, event_idx: int, session: str) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed, season, event_idx, _SESSION_IDS.get(session, 0))
        )

    def _skill(self, season: int) -> np.ndarray:
        """Driver pace offsets (seconds/lap) for a season; mild drift."""
        drift = np.random.default_rng((self.seed, season)).normal(
            0.0, 0.12, len(self.drivers)
        )
        team = np.array([self._team_pace[cfg.DRIVER_TEAMS[d]] for d in self.drivers])
        return self._base_skill + team + drift

    # -- backend protocol ----------------------------------------------------

    def get_schedule(self, season: int) -> list[dict]:
        events = []
        for i, circuit in enumerate(CALENDAR[: self.n_events]):
            events.append(
                {
                    "EventName": f"{circuit} Grand Prix",
                    "Location": circuit,
                    "EventFormat": "sprint_qualifying" if circuit in SPRINT_EVENTS else "conventional",
                    "EventDate": pd.Timestamp(f"{season}-03-01", tz="UTC")
                    + pd.Timedelta(days=14 * i),
                    "RoundNumber": i + 1,
                }
            )
        return events

    def _event_index(self, event: str) -> int | None:
        for i, circuit in enumerate(CALENDAR[: self.n_events]):
            if circuit.lower() in event.lower():
                return i
        return None

    def _base_lap(self, circuit: str) -> float:
        info = cfg.circuit_info(circuit)
        # Roughly constant race length: fewer laps -> longer lap.
        return 5400.0 / info["laps"]

    def load_laps(self, season: int, event: str, session: str) -> pd.DataFrame | None:
        idx = self._event_index(event)
        if idx is None:
            return None
        circuit = CALENDAR[idx]
        rng = self._rng(season, idx, session)
        skill = self._skill(season)
        base = self._base_lap(circuit)
        wet = circuit in WET_EVENTS and session in ("Q", "R")
        track_temp = float(rng.uniform(18 if wet else 25, 30 if wet else 50))

        rows = []
        if session in ("Q", "SQ"):
            n_laps_by_driver = rng.integers(2, 9, len(self.drivers))
            for di, driver in enumerate(self.drivers):
                # Better drivers run more laps (proxy for reaching Q3).
                n = int(n_laps_by_driver[di]) + (3 if skill[di] < 0 else 0)
                for lap_n in range(1, n + 1):
                    s1 = base * 0.30 + skill[di] * 0.3 + rng.normal(0, 0.12)
                    s2 = base * 0.38 + skill[di] * 0.4 + rng.normal(0, 0.15)
                    s3 = base * 0.32 + skill[di] * 0.3 + rng.normal(0, 0.12)
                    lt = s1 + s2 + s3 + (8.0 if wet else 0.0)
                    rows.append(
                        self._lap_row(
                            season, circuit, session, driver, lap_n, lt,
                            (s1, s2, s3), "SOFT", True, track_temp, wet,
                        )
                    )
        elif session.startswith("FP"):
            for di, driver in enumerate(self.drivers):
                n = int(rng.integers(12, 25))
                compound_cycle = ["SOFT", "MEDIUM", "HARD"]
                stint_age = 0
                compound = compound_cycle[int(rng.integers(3))]
                for lap_n in range(1, n + 1):
                    if stint_age > int(rng.integers(5, 9)):
                        stint_age = 0
                        compound = compound_cycle[int(rng.integers(3))]
                    deg = cfg.TIRE_COMPOUNDS[compound]["deg_rate"] * (
                        1.0 + 0.4 * skill[di]
                    )
                    pace_delta = cfg.TIRE_COMPOUNDS[compound]["pace_delta"]
                    lt = (
                        base + skill[di] + pace_delta + stint_age * max(deg, 0.01)
                        + rng.normal(0, 0.35)
                    )
                    is_pit = stint_age == 0 and lap_n > 1
                    s1 = lt * 0.30
                    s2 = lt * 0.38
                    s3 = lt * 0.32
                    rows.append(
                        self._lap_row(
                            season, circuit, session, driver, lap_n, lt,
                            (s1, s2, s3), compound, not is_pit, track_temp, False,
                            pit_out=is_pit,
                        )
                    )
                    stint_age += 1
        elif session in ("R", "S"):
            laps_total = int(cfg.circuit_info(circuit)["laps"]) if session == "R" else 18
            # simulate a crude race to get evolving positions
            finish = self._race_order(season, idx, session)
            dnf_laps = self._dnf_laps(season, idx, session, laps_total)
            for di, driver in enumerate(self.drivers):
                last = dnf_laps.get(driver, laps_total)
                compound = "MEDIUM"
                stint = 0
                for lap_n in range(1, last + 1):
                    if stint > 20:
                        stint = 0
                        compound = "HARD"
                    deg = cfg.TIRE_COMPOUNDS[compound]["deg_rate"]
                    lt = base + 1.0 + skill[di] + stint * deg + rng.normal(0, 0.5) + (
                        9.0 if wet else 0.0
                    )
                    pos = int(np.where(finish == di)[0][0]) + 1
                    rows.append(
                        self._lap_row(
                            season, circuit, session, driver, lap_n, lt,
                            (lt * 0.3, lt * 0.38, lt * 0.32), compound, True,
                            track_temp, wet, position=pos,
                        )
                    )
                    stint += 1
        else:
            return None
        return pd.DataFrame(rows)

    def _lap_row(
        self, season, circuit, session, driver, lap_n, lt, sectors, compound,
        accurate, track_temp, rainfall, pit_out=False, position=np.nan,
    ) -> dict:
        return {
            "Driver": driver,
            "Team": cfg.DRIVER_TEAMS[driver],
            "LapTime": float(lt),
            "LapNumber": int(lap_n),
            "Sector1Time": float(sectors[0]),
            "Sector2Time": float(sectors[1]),
            "Sector3Time": float(sectors[2]),
            "Compound": compound,
            "IsAccurate": bool(accurate),
            "PitInTime": np.nan,
            "PitOutTime": 1.0 if pit_out else np.nan,
            "Deleted": False,
            "TrackTemp": float(track_temp),
            "Rainfall": bool(rainfall),
            "Position": position,
        }

    def _race_order(self, season: int, event_idx: int, session: str) -> np.ndarray:
        """Finishing order (array of driver indices) — skill plus luck."""
        rng = np.random.default_rng(
            (self.seed, season, event_idx, _SESSION_IDS.get(session, 0), 99)
        )
        score = self._skill(season) + rng.normal(0, 0.6, len(self.drivers))
        return np.argsort(score)

    def _dnf_laps(
        self, season: int, event_idx: int, session: str, laps_total: int
    ) -> dict[str, int]:
        rng = np.random.default_rng(
            (self.seed, season, event_idx, _SESSION_IDS.get(session, 0), 7)
        )
        out = {}
        for driver in self.drivers:
            if rng.random() < 0.10:  # ~2 DNFs per race
                out[driver] = int(rng.integers(1, laps_total))
        return out

    def load_results(self, season: int, event: str, session: str = "R") -> pd.DataFrame | None:
        """Classification frame: Abbreviation, GridPosition, Position, Status.

        Known modeling wart (documented, deliberately unfixed): GridPosition
        comes from an independent quali-order draw (stream tag 99), not from
        ranking the Q-session lap frames, so an event's reported grid can
        disagree with its own Q classification — structural noise a real
        season would not have. Every statistical gate and documented Brier
        number is calibrated against this world AS IS (the repository's invariant: the
        synthetic world's draws are load-bearing), so aligning the two
        streams is a breaking change reserved for a deliberate recalibration
        round."""
        idx = self._event_index(event)
        if idx is None or session not in ("R", "S", "Q", "SQ"):
            return None
        circuit = CALENDAR[idx]
        if session in ("Q", "SQ"):
            laps = self.load_laps(season, event, session)
            best = laps.groupby("Driver")["LapTime"].min().sort_values()
            return pd.DataFrame(
                {
                    "Abbreviation": best.index,
                    "Position": np.arange(1, len(best) + 1, dtype=float),
                    "GridPosition": np.arange(1, len(best) + 1, dtype=float),
                    "Status": "Finished",
                }
            ).reset_index(drop=True)
        laps_total = int(cfg.circuit_info(circuit)["laps"]) if session == "R" else 18
        order = self._race_order(season, idx, session)
        dnfs = self._dnf_laps(season, idx, session, laps_total)
        grid_order = self._race_order(season, idx, "Q")
        grid_of = {int(d): g + 1 for g, d in enumerate(grid_order)}
        rows = []
        pos = 1
        # finishers first in race order, then DNFs
        for d in order:
            driver = self.drivers[int(d)]
            if driver in dnfs:
                continue
            rows.append((driver, grid_of[int(d)], pos, "Finished"))
            pos += 1
        for driver, lap in sorted(dnfs.items(), key=lambda kv: -kv[1]):
            d = self.drivers.index(driver)
            rows.append((driver, grid_of[d], pos, "Accident"))
            pos += 1
        return pd.DataFrame(
            rows, columns=["Abbreviation", "GridPosition", "Position", "Status"]
        )

    def load_weather(self, season: int, event: str, session: str) -> dict | None:
        idx = self._event_index(event)
        if idx is None:
            return None
        circuit = CALENDAR[idx]
        rng = self._rng(season, idx, session)
        wet = circuit in WET_EVENTS
        return {
            "air_temp": float(rng.uniform(15, 35)),
            "track_temp": float(rng.uniform(18 if wet else 25, 30 if wet else 50)),
            "humidity": float(rng.uniform(30, 90)),
            "rainfall": bool(wet),
            "wind_speed": float(rng.uniform(0, 12)),
        }
