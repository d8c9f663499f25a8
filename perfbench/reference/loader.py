"""Session data loading with layered backends and a real offline mode.

Reference parity: `F1DataLoader` (reference src/data_loader.py)
wrapped FastF1 with an in-memory memo and FastF1's own disk cache. This
rebuild generalizes to a backend stack:

    network (FastF1, when installed)  ->  normalized parquet disk cache
                                      ->  synthetic generator (tests/demo)

* `offline=True` forbids network access entirely: only the disk cache (and,
  if configured, the synthetic backend) serve data — the `--offline` flag the
  reference README advertises but never implements (README.md:27-47,
  SURVEY.md preamble).
* `build_cache(seasons)` pulls every session through the backend and
  persists normalized parquet/json — the `--build-cache` flag, likewise.

Normalized schema (float seconds, no Timedeltas): Driver, Team, LapTime,
LapNumber, Sector1Time..3, Compound, IsAccurate, PitInTime, PitOutTime,
Deleted, TrackTemp, Rainfall, Position.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pandas as pd

DEFAULT_WEATHER = {
    "air_temp": 25,
    "track_temp": 35,
    "humidity": 50,
    "rainfall": False,
    "wind_speed": 5,
}

_LAP_COLUMNS = [
    "Driver", "Team", "LapTime", "LapNumber", "Sector1Time", "Sector2Time",
    "Sector3Time", "Compound", "IsAccurate", "PitInTime", "PitOutTime",
    "Deleted", "TrackTemp", "Rainfall", "Position",
]


def _seconds(x):
    return x.total_seconds() if hasattr(x, "total_seconds") else x


class FastF1Backend:
    """Network backend over FastF1 (import-gated: fastf1 is an optional dependency)."""

    name = "fastf1"
    offline_safe = False  # network: blocked entirely by offline=True

    def __init__(self, fastf1_cache_dir: str = "./cache/fastf1"):
        import fastf1  # raises ImportError when not installed

        self._fastf1 = fastf1
        Path(fastf1_cache_dir).mkdir(parents=True, exist_ok=True)
        fastf1.Cache.enable_cache(fastf1_cache_dir)

    def get_schedule(self, season: int) -> list[dict]:
        schedule = self._fastf1.get_event_schedule(season)
        events = []
        for _, ev in schedule.iterrows():
            # EventDate -> Session5Date fallback: Series.get returns the
            # stored NaT (not the default) when the column exists, so a
            # missing/NaT EventDate must fall through to Session5Date
            # explicitly (the race session's date) before going dateless.
            date = ev.get("EventDate")
            if date is None or pd.isna(date):
                date = ev.get("Session5Date")
            events.append(
                {
                    "EventName": ev["EventName"],
                    "Location": ev.get("Location", ev["EventName"]),
                    "EventFormat": str(ev.get("EventFormat", "conventional")),
                    "EventDate": pd.to_datetime(date),
                    "RoundNumber": int(ev.get("RoundNumber", 0)),
                }
            )
        return events

    def load_laps(self, season: int, event: str, session: str) -> pd.DataFrame | None:
        try:
            sess = self._fastf1.get_session(season, event, session)
            sess.load()
            laps = sess.laps
        except Exception as e:  # noqa: BLE001 — graceful degradation (data_loader.py:31)
            print(f"Warning: could not load {season} {event} {session}: {e}")
            return None
        if laps is None or laps.empty:
            return None
        out = pd.DataFrame()
        for col in _LAP_COLUMNS:
            if col in laps.columns:
                series = laps[col]
                if col.endswith("Time") and col not in ("PitInTime", "PitOutTime"):
                    series = series.apply(_seconds)
                elif col in ("PitInTime", "PitOutTime"):
                    series = series.notna().map({True: 1.0, False: np.nan})
                out[col] = series.to_numpy()
            else:
                out[col] = np.nan
        return out

    def load_results(self, season: int, event: str, session: str = "R") -> pd.DataFrame | None:
        try:
            sess = self._fastf1.get_session(season, event, session)
            sess.load()
            res = sess.results
        except Exception:  # noqa: BLE001
            return None
        if res is None or res.empty:
            return None
        cols = {}
        for col in ("Abbreviation", "GridPosition", "Position", "Status"):
            cols[col] = res[col] if col in res.columns else np.nan
        return pd.DataFrame(cols)

    def load_weather(self, season: int, event: str, session: str) -> dict | None:
        try:
            sess = self._fastf1.get_session(season, event, session)
            sess.load(weather=True, laps=False, telemetry=False, messages=False)
            w = sess.weather_data
        except Exception:  # noqa: BLE001
            return None
        if w is None or w.empty:
            return None

        def mean_or(col, fallback):
            if col not in w.columns:
                return fallback
            v = w[col].mean()
            return float(v) if pd.notna(v) else fallback

        return {
            "air_temp": mean_or("AirTemp", DEFAULT_WEATHER["air_temp"]),
            "track_temp": mean_or("TrackTemp", DEFAULT_WEATHER["track_temp"]),
            "humidity": mean_or("Humidity", DEFAULT_WEATHER["humidity"]),
            "rainfall": bool(w["Rainfall"].any()) if "Rainfall" in w.columns else False,
            "wind_speed": mean_or("WindSpeed", DEFAULT_WEATHER["wind_speed"]),
        }


# Process-wide parquet frame cache keyed by (path, mtime_ns, size): the
# walk-forward backtest builds a FRESH predictor per season (leakage
# control), so the same on-disk event files are re-read by every season's
# loader instance — ~2 s/season of pyarrow reads for data that has not
# changed. Keying on stat() makes an overwrite (e.g. --build-cache) a
# cache miss. Frames are shared by reference, same as the per-instance
# `_memo`: all internal consumers treat loaded frames as immutable
# (`.assign`/boolean-mask copies).
_FRAME_CACHE: dict = {}
_FRAME_CACHE_MAX = 1024


def _read_parquet_cached(p: Path) -> pd.DataFrame:
    st = p.stat()
    key = (str(p), st.st_mtime_ns, st.st_size)
    df = _FRAME_CACHE.get(key)
    if df is None:
        df = pd.read_parquet(p)
        if len(_FRAME_CACHE) >= _FRAME_CACHE_MAX:
            _FRAME_CACHE.pop(next(iter(_FRAME_CACHE)))
        _FRAME_CACHE[key] = df
    return df


class DiskCacheBackend:
    """Read-only backend over the normalized parquet/json cache."""

    name = "disk"

    def __init__(self, cache_dir: str | Path):
        self.root = Path(cache_dir)

    def _event_dir(self, season: int, event: str) -> Path:
        return self.root / str(season) / event.replace("/", "_")

    def get_schedule(self, season: int) -> list[dict] | None:
        p = self.root / str(season) / "schedule.json"
        if not p.exists():
            return None
        events = json.loads(p.read_text())
        for ev in events:
            ev["EventDate"] = pd.to_datetime(ev["EventDate"])
        return events

    def load_laps(self, season: int, event: str, session: str) -> pd.DataFrame | None:
        p = self._event_dir(season, event) / f"laps_{session}.parquet"
        return _read_parquet_cached(p) if p.exists() else None

    def load_results(self, season: int, event: str, session: str = "R") -> pd.DataFrame | None:
        p = self._event_dir(season, event) / f"results_{session}.parquet"
        return _read_parquet_cached(p) if p.exists() else None

    def load_weather(self, season: int, event: str, session: str) -> dict | None:
        p = self._event_dir(season, event) / f"weather_{session}.json"
        return json.loads(p.read_text()) if p.exists() else None

    # -- writing (used by build_cache) ---------------------------------------

    def store_schedule(self, season: int, events: list[dict]) -> None:
        p = self.root / str(season) / "schedule.json"
        p.parent.mkdir(parents=True, exist_ok=True)
        serializable = [
            {**ev, "EventDate": str(ev["EventDate"])} for ev in events
        ]
        p.write_text(json.dumps(serializable, indent=1))

    def store_laps(self, season: int, event: str, session: str, df: pd.DataFrame) -> None:
        d = self._event_dir(season, event)
        d.mkdir(parents=True, exist_ok=True)
        df.to_parquet(d / f"laps_{session}.parquet")

    def store_results(self, season: int, event: str, session: str, df: pd.DataFrame) -> None:
        d = self._event_dir(season, event)
        d.mkdir(parents=True, exist_ok=True)
        df.to_parquet(d / f"results_{session}.parquet")

    def store_weather(self, season: int, event: str, session: str, w: dict) -> None:
        d = self._event_dir(season, event)
        d.mkdir(parents=True, exist_ok=True)
        (d / f"weather_{session}.json").write_text(json.dumps(w))


class F1DataLoader:
    """Facade with the reference's public surface (data_loader.py:8-156):
    `load_session`, `load_season_data`, `get_weather` — plus schedule access,
    offline mode, and cache building."""

    def __init__(
        self,
        cache_dir: str | Path = "./cache",
        offline: bool = False,
        backend=None,
        now: pd.Timestamp | None = None,
    ):
        self.cache = DiskCacheBackend(Path(cache_dir) / "sessions")
        self.offline = offline
        self._memo: dict[tuple, pd.DataFrame] = {}
        self._now = now or pd.Timestamp.now(tz="UTC")
        self._strict_clock = False  # set by set_now (walk-forward pinning)
        if backend is not None:
            self.backend = backend
        elif offline:
            self.backend = None
        else:
            try:
                self.backend = FastF1Backend(str(Path(cache_dir) / "fastf1"))
            except ImportError:
                self.backend = None

    def _backend_allowed(self) -> bool:
        """offline=True forbids NETWORK access, not every backend: a
        backend declaring `offline_safe = True` (the synthetic generator —
        it fabricates data locally) still serves, matching the module
        docstring's offline contract. FastF1 (offline_safe=False, the
        default) stays blocked."""
        if self.backend is None:
            return False
        if not self.offline:
            return True
        return getattr(self.backend, "offline_safe", False)

    @property
    def now(self) -> pd.Timestamp:
        """The loader's clock: only events dated <= now are 'past'."""
        return self._now

    def set_now(self, now: pd.Timestamp) -> None:
        """Re-pin the loader's clock. Used by the walk-forward backtest to
        restrict `past_events` (and everything derived from it — Elo season
        builds, feature archives) to races strictly before the race being
        predicted, eliminating look-ahead leakage when backtesting a season
        that has already completed in wall-clock time. Session-level loads
        (`load_session`, `load_results`, `get_weather`) are clock-free; only
        schedule filtering changes, so memoized session data stays valid.

        Pinning also switches `past_events` to STRICT mode: events with a
        missing date can no longer be ordered against the pinned clock, so
        they are excluded rather than included (an included dateless race
        would leak its results into Elo/features for every race of the
        backtest — its actuals still flow through the explicit walk-forward
        updates)."""
        now = pd.to_datetime(now)
        if now.tzinfo is None:
            now = now.tz_localize("UTC")
        self._now = now
        self._strict_clock = True

    # -- core loads ----------------------------------------------------------

    def _resolve_event(self, season: int, race: str) -> str:
        """Resolve a user-supplied race name ('Bahrain') to the schedule's
        event name ('Bahrain Grand Prix'). FastF1's `get_session` fuzzy-
        matches names itself; the disk cache and schedule-keyed paths need
        the same forgiveness."""
        schedule = self.get_schedule(season)
        names = [ev["EventName"] for ev in schedule]
        if race in names or not names:
            return race
        low = race.lower()
        for ev in schedule:
            if low in str(ev["EventName"]).lower() or low in str(
                ev.get("Location", "")
            ).lower():
                return ev["EventName"]
        return race

    def _load(self, kind: str, season: int, event: str, session: str):
        event = self._resolve_event(season, event)
        key = (kind, season, event, session)
        if key in self._memo:
            return self._memo[key]
        loader = {
            "laps": "load_laps",
            "results": "load_results",
            "weather": "load_weather",
        }[kind]
        out = getattr(self.cache, loader)(season, event, session)
        if out is None and self._backend_allowed():
            out = getattr(self.backend, loader)(season, event, session)
            if out is not None:
                store = getattr(self.cache, "store_" + kind)
                store(season, event, session, out)
        if out is not None and not (isinstance(out, pd.DataFrame) and out.empty):
            self._memo[key] = out
        return out

    def load_session(self, season: int, race: str, session: str) -> pd.DataFrame:
        """Lap data for one session (FP1/FP2/FP3/Q/SQ/S/R); empty frame on
        failure (reference data_loader.py:15-33)."""
        out = self._load("laps", season, race, session)
        return out if out is not None else pd.DataFrame()

    def load_results(self, season: int, race: str, session: str = "R") -> pd.DataFrame:
        out = self._load("results", season, race, session)
        return out if out is not None else pd.DataFrame()

    def get_weather(self, season: int, race: str, session: str) -> dict:
        """Aggregated weather with NaN-safe defaults (data_loader.py:132-156)."""
        out = self._load("weather", season, race, session)
        return dict(out) if out else dict(DEFAULT_WEATHER)

    def get_schedule(self, season: int) -> list[dict]:
        key = ("schedule", season)
        if key in self._memo:
            return self._memo[key]
        events = self.cache.get_schedule(season)
        if events is None:
            if self._backend_allowed():
                events = self.backend.get_schedule(season)
                if events:
                    self.cache.store_schedule(season, events)
            else:
                events = []
        if events:
            self._memo[key] = events
        return events or []

    def past_events(self, season: int) -> list[dict]:
        """Non-testing events whose date has passed (data_loader.py:48-60).

        Dateless (NaT) events pass the filter in normal operation (reference
        parity) but are EXCLUDED once the clock has been pinned via
        `set_now` — see there."""
        out = []
        for ev in self.get_schedule(season):
            if str(ev.get("EventFormat", "")) == "testing":
                continue
            date = ev.get("EventDate")
            if date is not None and pd.notna(date):
                date = pd.to_datetime(date)
                if date.tzinfo is None:
                    date = date.tz_localize("UTC")
                if date > self._now:
                    continue
            elif getattr(self, "_strict_clock", False):
                continue
            out.append(ev)
        return out

    # -- season extraction (data_loader.py:35-130) ----------------------------

    def load_season_data(self, season: int) -> dict:
        """All qualifying/race/sprint results for a season, in calendar
        order, as {(driver, value)} event lists for the Elo builder."""
        results = {"qualifying": [], "races": [], "sprints": [], "sprint_qualifying": []}
        for ev in self.past_events(season):
            name = ev["EventName"]
            q = self.load_session(season, name, "Q")
            if not q.empty:
                extracted = extract_quali_results(q)
                if extracted:
                    results["qualifying"].append(extracted)
            r = self.load_session(season, name, "R")
            if not r.empty:
                extracted = extract_race_results(r)
                if extracted:
                    results["races"].append(extracted)
            if "sprint" in str(ev.get("EventFormat", "")).lower():
                sq = self.load_session(season, name, "SQ")
                if not sq.empty:
                    extracted = extract_quali_results(sq)
                    if extracted:
                        results["sprint_qualifying"].append(extracted)
                s = self.load_session(season, name, "S")
                if not s.empty:
                    extracted = extract_race_results(s)
                    if extracted:
                        results["sprints"].append(extracted)
        return results

    # -- cache building -------------------------------------------------------

    def build_cache(self, seasons: list[int], sessions: tuple[str, ...] = (
        "FP1", "FP2", "FP3", "Q", "SQ", "S", "R"
    )) -> int:
        """Pull and persist every session for `seasons`. Returns the number
        of session artifacts written. Requires a live backend."""
        if self.backend is None:
            raise RuntimeError(
                "build_cache requires a data backend (FastF1 or synthetic)"
            )
        written = 0
        for season in seasons:
            events = self.backend.get_schedule(season)
            self.cache.store_schedule(season, events)
            for ev in events:
                if str(ev.get("EventFormat", "")) == "testing":
                    # Pre-season testing events have no Q/R sessions; the
                    # reference's season iteration skips them implicitly
                    # (data_loader.py:48-60 event filter) and past_events
                    # mirrors that — skip them here too instead of issuing
                    # doomed session loads against the live API.
                    continue
                name = ev["EventName"]
                is_sprint = "sprint" in str(ev.get("EventFormat", "")).lower()
                for session in sessions:
                    if session in ("SQ", "S") and not is_sprint:
                        continue
                    laps = self.backend.load_laps(season, name, session)
                    if laps is not None and not laps.empty:
                        self.cache.store_laps(season, name, session, laps)
                        written += 1
                    if session in ("Q", "SQ", "S", "R"):
                        res = self.backend.load_results(season, name, session)
                        if res is not None and not res.empty:
                            self.cache.store_results(season, name, session, res)
                            written += 1
                    w = self.backend.load_weather(season, name, session)
                    if w is not None:
                        self.cache.store_weather(season, name, session, w)
                        written += 1
        return written


# -- result extraction (reference data_loader.py:86-130) ----------------------


def extract_quali_results(laps: pd.DataFrame) -> list[tuple[str, float]]:
    """(driver, best_accurate_lap_seconds) sorted fastest-first."""
    if "IsAccurate" in laps.columns and laps["IsAccurate"].notna().any():
        valid = laps[laps["IsAccurate"].fillna(False).astype(bool)]
    else:
        mask = pd.Series(True, index=laps.index)
        for col in ("PitInTime", "PitOutTime"):
            if col in laps.columns:
                mask &= laps[col].isna()
        if "Deleted" in laps.columns:
            mask &= laps["Deleted"].fillna(False).astype(bool) != True  # noqa: E712
        valid = laps[mask]
    if valid.empty:
        valid = laps
    best = valid.groupby("Driver")["LapTime"].min().sort_values()
    return [(d, float(t)) for d, t in best.items() if pd.notna(t)]


def extract_race_results(laps: pd.DataFrame) -> list[tuple[str, int]]:
    """(driver, final_position) from each driver's last lap."""
    if laps.empty or "Position" not in laps.columns:
        return []
    if "LapNumber" in laps.columns:
        laps = laps.sort_values("LapNumber")
    final = laps.groupby("Driver").last()
    out = []
    for d, row in final.iterrows():
        pos = row.get("Position")
        if pd.notna(pos):
            out.append((d, int(pos)))
    return out
