"""The entry-list world: a frozen copy of the port's synthetic world
(`monte_carlo_gp_torch/data/synthetic.py`) as it stood when the season-keyed
entry lists were added, built on the frozen generator beside this file
(`synthetic.py`, unedited), in plain numpy and pandas.

A season named in `entry_lists` fields the drivers of its list, driver ->
team in the list's order; every other season is the frozen generator's, the
2025 map (`config.DRIVER_TEAMS`) in every season, frame for frame. Each
entry-list season is served by a view of the frozen generator that shares
its seed, calendar, skills and team paces and fields the list:

  * a driver the 2025 map names keeps the skill drawn for that name; a
    newcomer's skill is drawn from a generator keyed by the driver's code,
    `(seed, 1, crc32(code))`, N(0, 0.45) as the 2025 drivers' were;
  * a team the 2025 map names keeps its pace; a new team name draws its own,
    `(seed, 2, crc32(name))`, N(0, 0.35): Audi, Sauber renamed, is a new
    name and so a new pace, as Cadillac's is;
  * the season's drift, the session draws and the classification are the
    frozen generator's, over the list's drivers in the list's order.

Departures from the season it stands for, each on purpose: the world is
synthetic; its calendar is the frozen generator's 20 rounds, where the 2026
season has 24; the list is the one published before the season, with no
mid-season change of driver; the frames carry the list's team names, while
the predictor's team DNF rates come from the static 2025 map
(`config.DEFAULT_DNF_RATES` by `config.DRIVER_TEAMS`), as upstream's do, so
HAD and LAW take their 2025 teams' rates and LIN, COL, PER and BOT the 0.002
fallback. The JAX package's world has no entry lists: its 2026 fields the
2025 map's 20 drivers.

Nothing here imports JAX, the JAX package or a kernel of the port; the
reference's torch work runs under `exact_float32` (no TF32).
"""

from __future__ import annotations

import zlib

import numpy as np
import pandas as pd

from perfbench.reference import synthetic
from perfbench.reference.tune import exact_float32

__all__ = ["RosterBackend", "exact_float32"]

NEW_DRIVER, NEW_TEAM = 1, 2


def _own_draw(seed: int, tag: int, name: str, scale: float) -> float:
    rng = np.random.default_rng((seed, tag, zlib.crc32(name.encode())))
    return float(rng.normal(0.0, scale))


class _Field(synthetic.SyntheticBackend):
    """The frozen generator at one season whose field is an entry list."""

    def __init__(self, world: synthetic.SyntheticBackend, entry_list: dict[str, str]):
        self.seed, self.n_events = world.seed, world.n_events
        self.teams = dict(entry_list)
        self.drivers = list(self.teams)
        known = dict(zip(world.drivers, world._base_skill))
        self._base_skill = np.array([
            known[d] if d in known else _own_draw(self.seed, NEW_DRIVER, d, 0.45)
            for d in self.drivers
        ])
        self._pace = np.array([
            world._team_pace[t] if t in world._team_pace
            else _own_draw(self.seed, NEW_TEAM, t, 0.35)
            for t in self.teams.values()
        ])

    def _skill(self, season: int) -> np.ndarray:
        drift = np.random.default_rng((self.seed, season)).normal(
            0.0, 0.12, len(self.drivers)
        )
        return self._base_skill + self._pace + drift

    def _lap_row(
        self, season, circuit, session, driver, lap_n, lt, sectors, compound,
        accurate, track_temp, rainfall, pit_out=False, position=np.nan,
    ) -> dict:
        return {
            "Driver": driver,
            "Team": self.teams[driver],
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


class RosterBackend(synthetic.SyntheticBackend):
    """The frozen synthetic world with `entry_lists` ({season: {driver:
    team}}) fielding their seasons."""

    def __init__(self, seed: int, entry_lists: dict[int, dict[str, str]],
                 n_events: int | None = None):
        super().__init__(seed=seed, n_events=n_events)
        self.fields = {int(s): _Field(self, lst) for s, lst in entry_lists.items()}

    def load_laps(self, season: int, event: str, session: str) -> pd.DataFrame | None:
        if season in self.fields:
            return self.fields[season].load_laps(season, event, session)
        return super().load_laps(season, event, session)

    def load_results(self, season: int, event: str, session: str = "R") -> pd.DataFrame | None:
        if season in self.fields:
            return self.fields[season].load_results(season, event, session)
        return super().load_results(season, event, session)
