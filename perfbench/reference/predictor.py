"""The host layer of a weekend: a frozen copy of
`monte_carlo_gp_torch/models/predictor.py`'s `F1Predictor` (its
`prepare_weekend` and `assemble_result` and their helpers) as the port had
it when the benchmark was written, with the device, engine, mesh and Elo
cache taken out. It re-derives every plan the benchmark compares; the
Monte Carlo is `race.py`'s and the Bayesian grid `bayes.py`'s.
"""

from __future__ import annotations

import dataclasses
import zlib
from pathlib import Path

import numpy as np
import pandas as pd

from perfbench.reference import config as cfg
from perfbench.reference.features import F1FeatureEngine, _driver_groups, _to_float
from perfbench.reference.elo import F1EloSystem
from perfbench.reference.loader import F1DataLoader


def log_event(*_args, **_kwargs) -> None:
    """The frozen copy logs nothing."""


class InsufficientDataError(ValueError):
    """No practice data for a weekend."""

# FP-session fallback chains per prediction point.
SESSION_CHAINS: dict[str, list[str]] = {
    "fp1": ["FP1"],
    "fp2": ["FP2", "FP1"],
    "fp3": ["FP3", "FP2", "FP1"],
    "quali": ["FP3", "FP2", "FP1"],
    "sprint": ["FP3", "FP2", "FP1"],
}
DEFAULT_CHAIN = ["FP2", "FP3", "FP1"]

# Variance multipliers per prediction point.
UNCERTAINTY_MULTIPLIER = {
    "fp1": 1.5,
    "fp2": 1.2,
    "fp3": 1.0,
    "quali": 0.9,
    "sprint": 0.85,
}
CONFIDENCE_LEVELS = {
    "fp1": "low",
    "fp2": "moderate",
    "fp3": "good",
    "quali": "high",
    "sprint": "high",
}

DEFAULT_PACE = 90.0
DEFAULT_DEG = 0.05
ELO_SEASON_FLOOR = 2017  # seasons must be > this


@dataclasses.dataclass(frozen=True)
class WeekendPlan:
    """A fully prepared race weekend: simulation inputs + result-assembly
    context. `prepare_weekend` produces it; `assemble_result` consumes it
    along with a simulated (D, D) finish-probability matrix."""

    params: cfg.SimParams
    total_laps: int
    drivers: list[str]
    quali_probs: dict[str, list[float]]
    weather: dict
    prediction_point: str
    grid_is_actual: bool


class F1Predictor:
    """The host side of the port's weekend orchestrator. `quali_model`
    "bayesian" takes its grid from `bayes_model` (`bayes.DeferredBayes`),
    which fits later, in one batch."""

    def __init__(
        self,
        cache_dir: str | Path = "./cache",
        offline: bool = False,
        backend=None,
        now: pd.Timestamp | None = None,
        rookie_prior: bool = False,
        quali_model: str = "elo",
        bayes_model=None,
    ):
        if quali_model not in ("elo", "bayesian"):
            raise ValueError(f"the reference has no quali_model {quali_model!r}")
        self._quali_model = quali_model
        self._bayes_model = bayes_model
        self.data_loader = F1DataLoader(
            cache_dir=cache_dir, offline=offline, backend=backend, now=now
        )
        self.feature_engine = F1FeatureEngine(self.data_loader)
        self.elo_system = F1EloSystem()
        self._processed_seasons: set[int] = set()
        self._features_loaded = False
        self._features_now = None  # loader clock at last feature load
        self.last_effective_sims: int | None = None
        self._rookie_prior = rookie_prior

    # -- small helpers -------------------------------------------------------------

    def _get_circuit_info(self, race: str) -> dict:
        return cfg.circuit_info(race)

    def apply_grid_penalties(
        self, quali_positions: dict[str, int], penalties: dict[str, int | str]
    ) -> dict[str, int]:
        """Re-rank a grid after penalties; quali position breaks ties."""
        resolved = {d: cfg.resolve_penalty(p) for d, p in penalties.items()}
        ranked = sorted(quali_positions.items(), key=lambda kv: kv[1])
        penalized = [(d, pos + resolved.get(d, 0), pos) for d, pos in ranked]
        penalized.sort(key=lambda x: (x[1], x[2]))
        return {d: i + 1 for i, (d, _, _) in enumerate(penalized)}

    # -- Elo construction ----------------------------------------------------------

    def _build_elo(self, season: int) -> list[int]:
        historical = sorted(
            s for s in range(season - 1, season + 1) if s > ELO_SEASON_FLOOR
        )
        for hist in historical:
            if hist in self._processed_seasons:
                continue
            try:
                years_ago = season - hist
                data = self.data_loader.load_season_data(hist)
                total = len(data["qualifying"])
                for idx, ev in enumerate(data["qualifying"]):
                    self.elo_system.set_recency_weight(years_ago, idx, total)
                    self.elo_system.update_quali_ratings(ev)
                for idx, ev in enumerate(data.get("sprint_qualifying", [])):
                    self.elo_system.set_recency_weight(years_ago, idx, total)
                    self.elo_system.update_quali_ratings(ev)
                for idx, ev in enumerate(data["races"]):
                    self.elo_system.set_recency_weight(years_ago, idx, total)
                    self.elo_system.update_race_ratings(ev)
                for idx, ev in enumerate(data.get("sprints", [])):
                    self.elo_system.set_recency_weight(years_ago, idx, total)
                    self.elo_system.update_race_ratings(ev)
                self._processed_seasons.add(hist)
            except Exception:  # noqa: BLE001 — a season that fails to load is skipped
                pass
        return historical

    # -- the main pipeline -----------------------------------------------------------

    def prepare_weekend(
        self,
        season: int,
        race: str,
        grid_penalties: dict[str, int | str] | None = None,
        circuit_info: dict | None = None,
        prediction_point: str = "fp2",
        actual_grid: dict[str, int] | None = None,
    ) -> WeekendPlan:
        """Everything up to (but not including) the Monte Carlo: data loads,
        Elo builds, features, practice extraction, SimParams assembly (on the
        CPU)."""
        grid_penalties = grid_penalties or {}
        circuit_info = circuit_info or self._get_circuit_info(race)

        historical_seasons = self._build_elo(season)
        # Features load once per loader clock, so feature inputs only see
        # races strictly before the one being predicted.
        loader_now = self.data_loader.now
        if historical_seasons and (
            not self._features_loaded or self._features_now != loader_now
        ):
            self.feature_engine.load_historical_data(historical_seasons)
            self._features_loaded = True
            self._features_now = loader_now

        # FP data via fallback chain.
        fp_data = pd.DataFrame()
        for session in SESSION_CHAINS.get(prediction_point, DEFAULT_CHAIN):
            fp_data = self.data_loader.load_session(season, race, session)
            if not fp_data.empty:
                break
        weather = self.data_loader.get_weather(season, race, "R")
        if fp_data.empty:
            raise InsufficientDataError(
                f"No practice data available for {season} {race}"
            )

        drivers = fp_data["Driver"].unique().tolist()
        # The weekend's driver→team assignment comes from the session frame;
        # the static 2025 map is only the fallback for rows without a Team.
        weekend_teams = self._teams_from_fp(fp_data, drivers)

        # Rookie seeding (opt-in): drivers with no rated history get a
        # teammate-prior Elo, batched so two unrated teammates get
        # order-independent priors.
        if self._rookie_prior:
            rookies = {
                d: weekend_teams.get(d)
                for d in drivers
                if not self.elo_system.has_rating(d)
            }
            if rookies:
                seeded = self.elo_system.initialize_rookies(
                    rookies, weekend_teams
                )
                for d, rating in seeded.items():
                    log_event("rookie_initialized", driver=d, rating=rating)

        # Qualifying probabilities: actual grid or model prediction.
        if actual_grid and prediction_point in ("quali", "sprint"):
            quali_probs = self._grid_to_probs(drivers, actual_grid)
        else:
            quali_probs = None
            if self._quali_model != "elo":
                # The alternative models match circuits exactly against the
                # archive's resolved event names, so a short name
                # ('Bahrain') is resolved first; unresolved, it would
                # silently zero the circuit signal.
                circuit = self.data_loader._resolve_event(season, race)
                quali_probs = self._predict_quali_alt(
                    drivers, circuit, season, weekend_teams
                )
            if quali_probs is None:
                quali_features = {
                    d: self.feature_engine.calculate_quali_features(d, race)
                    for d in drivers
                }
                quali_probs = self._predict_quali(drivers, quali_features)
        if grid_penalties:
            quali_probs = self._adjust_for_penalties(quali_probs, grid_penalties)

        # Practice-data extraction.
        base_pace = self._extract_race_pace(fp_data)
        tire_deg = self._extract_tire_deg(fp_data)
        dynamic_compounds = self._extract_tire_compound_deltas(fp_data)

        race_features = {
            d: self.feature_engine.calculate_race_features(d, race, weather)
            for d in drivers
        }
        # Clutch-shaped variance, then the prediction-point multiplier, cap 0.3.
        mult = UNCERTAINTY_MULTIPLIER.get(prediction_point, 1.0)
        driver_variance = {
            d: min(
                0.3,
                max(0.05, min(0.25, 0.15 * (1 - race_features[d].get("clutch_factor", 0) * 0.2)))
                * mult,
            )
            for d in drivers
        }

        total_laps = int(circuit_info.get("laps", 58))
        driver_dnf_rates = {
            d: race_features[d].get("dnf_probability", 0.05) / total_laps
            for d in drivers
        }

        track_condition = "damp" if weather.get("rainfall", False) else "dry"

        # Team-trend and wet-skill pace adjustments.
        for d in drivers:
            base_pace[d] = base_pace.get(d, DEFAULT_PACE) - (
                race_features[d].get("team_trend", 0) * 0.6
            )
        if track_condition in ("damp", "wet"):
            for d in drivers:
                base_pace[d] -= race_features[d].get("wet_performance", 0) * 0.5

        params = self._make_params(
            drivers=drivers,
            quali_probs=quali_probs,
            base_pace=base_pace,
            tire_deg=tire_deg,
            driver_variance=driver_variance,
            driver_dnf_rates=driver_dnf_rates,
            circuit_info=circuit_info,
            dynamic_compounds=dynamic_compounds,
            track_condition=track_condition,
        )
        return WeekendPlan(
            params=params,
            total_laps=total_laps,
            drivers=drivers,
            quali_probs=quali_probs,
            weather=weather,
            prediction_point=prediction_point,
            # an empty dict must not label a model-predicted grid as actual
            grid_is_actual=bool(actual_grid)
            and prediction_point in ("quali", "sprint"),
        )

    def assemble_result(self, plan: WeekendPlan, probs: np.ndarray) -> dict:
        """The result dict from a (D, D) finish-probability matrix."""
        drivers = plan.drivers
        quali_probs = plan.quali_probs
        n = len(drivers)
        race_probs = {
            d: {p + 1: float(probs[i, p]) for p in range(n) if probs[i, p] > 0}
            for i, d in enumerate(drivers)
        }
        return {
            "pole_probabilities": {
                d: (quali_probs[d][0] if quali_probs.get(d) else 1.0 / max(1, n))
                for d in drivers
            },
            "win_probabilities": {d: race_probs.get(d, {}).get(1, 0.0) for d in drivers},
            "podium_probabilities": {
                d: sum(race_probs.get(d, {}).get(p, 0.0) for p in (1, 2, 3))
                for d in drivers
            },
            "full_distributions": race_probs,
            "weather": plan.weather,
            "prediction_point": plan.prediction_point,
            "confidence": CONFIDENCE_LEVELS.get(plan.prediction_point, "moderate"),
            "grid_is_actual": plan.grid_is_actual,
            "n_simulations_effective": self.last_effective_sims,
        }

    # -- qualifying model -------------------------------------------------------------

    @staticmethod
    def _teams_from_fp(
        fp_data: pd.DataFrame, drivers: list[str]
    ) -> dict[str, str | None]:
        """Weekend driver→team from the session frame (first non-null Team
        per driver), falling back to cfg.DRIVER_TEAMS only for rows with no
        Team value."""
        from_frame: dict[str, str] = {}
        if "Team" in fp_data.columns:
            teams = fp_data[["Driver", "Team"]].dropna()
            from_frame = teams.groupby("Driver", sort=False)["Team"].first().to_dict()
        return {
            d: from_frame.get(d) or cfg.DRIVER_TEAMS.get(d) for d in drivers
        }

    def _predict_quali_alt(
        self,
        drivers: list[str],
        race: str,
        season: int,
        driver_teams: dict[str, str | None] | None = None,
    ) -> dict[str, list[float]] | None:
        """The qualifying grid from the alternative model, fitted on the
        historical qualifying archive. Returns None, and logs why, when the
        archive cannot support a fit (an empty archive, or the model's
        ValueError), so that prepare_weekend takes the Elo path instead of
        failing the weekend. A refused or failed HMC kernel
        (`hmc_kernel.HMCKernelError`, a RuntimeError) is no such reason and
        fails the weekend.

        Deterministic: the fit is cached per archive build with a fixed
        seed, and the grid noise is seeded with crc32 of "season:race"
        (never Python's hash, which varies per process)."""
        laps = self.feature_engine.laps
        if laps.empty:
            log_event(
                "alt_quali_fallback",
                model=self._quali_model,
                reason="empty_archive",
                race=race,
            )
            return None
        noise_seed = zlib.crc32(f"{season}:{race}".encode())
        if driver_teams is None:
            driver_teams = {d: cfg.DRIVER_TEAMS.get(d) for d in drivers}
        try:
            return self._bayes_model.predict(
                laps, drivers, driver_teams, circuit=race, seed=noise_seed
            )
        except ValueError as e:
            log_event(
                "alt_quali_fallback",
                model=self._quali_model,
                reason=str(e),
                race=race,
            )
            return None

    def _predict_quali(
        self, drivers: list[str], features: dict
    ) -> dict[str, list[float]]:
        if not drivers:
            return {}
        elo_probs = self.elo_system.predict_quali_probs(drivers)
        # Teammate boost, clamped [0.5, 1.5].
        for d in drivers:
            delta = features.get(d, {}).get("teammate_delta", 0)
            if delta != 0 and d in elo_probs:
                boost = 1 + delta * 0.25
                elo_probs[d] = elo_probs[d] * max(0.5, min(1.5, boost))
        total = sum(elo_probs.values())
        if total > 0:
            elo_probs = {d: p / total for d, p in elo_probs.items()}

        n = len(drivers)
        sigma = max(1.0, n / 4)
        result = {}
        for d in drivers:
            base_prob = elo_probs.get(d, 1 / n)
            f = features.get(d, {})
            adjusted = base_prob * (
                1 + f.get("form_score", 0) * 0.15 + f.get("circuit_affinity", 0) * 0.10
            )
            adjusted = max(0.001, min(0.999, adjusted))
            expected_pos = (1 - adjusted) * n
            pos = np.arange(n, dtype=np.float64)
            probs = np.exp(-((pos - expected_pos) ** 2) / (2 * sigma**2))
            total = probs.sum()
            result[d] = (
                (probs / total).tolist() if total > 0 else [1.0 / n] * n
            )
        return result

    @staticmethod
    def _grid_to_probs(drivers: list[str], actual_grid: dict[str, int]) -> dict:
        """Deterministic position distributions from a known grid;
        out-of-range or missing drivers go last."""
        n = len(drivers)
        out = {}
        for d in drivers:
            probs = [0.0] * n
            if d in actual_grid and 0 <= actual_grid[d] - 1 < n:
                probs[actual_grid[d] - 1] = 1.0
            else:
                probs[-1] = 1.0
            out[d] = probs
        return out

    def _adjust_for_penalties(
        self, quali_probs: dict, penalties: dict[str, int | str]
    ) -> dict[str, list[float]]:
        """Shift distributions back by penalty positions."""
        adjusted = {}
        for d, probs in quali_probs.items():
            penalty = cfg.resolve_penalty(penalties.get(d, 0))
            if penalty > 0 and len(probs) > 0:
                n = len(probs)
                if penalty >= n:
                    shifted = [0.0] * (n - 1) + [1.0]
                else:
                    shifted = [0.0] * n
                    for i, p in enumerate(probs):
                        shifted[min(i + penalty, n - 1)] += p
                adjusted[d] = shifted
            else:
                adjusted[d] = probs
        return adjusted

    # -- practice-data extraction ---------------------------------------------------------

    @staticmethod
    def _extract_race_pace(fp_data: pd.DataFrame) -> dict[str, float]:
        """Long-run pace per driver: median of the middle laps, excluding pit
        in/out laps; 25th percentile below 3 laps; field median for drivers
        without valid times."""
        if fp_data.empty:
            return {}
        mask = np.ones(len(fp_data), bool)
        for col in ("PitInTime", "PitOutTime"):
            if col in fp_data.columns:
                mask &= np.isnan(_to_float(fp_data[col]))
        drv_all = np.asarray(fp_data["Driver"], dtype=object)
        drv = drv_all[mask]
        lt = _to_float(fp_data["LapTime"])[mask]
        if "LapNumber" in fp_data.columns:
            order = np.lexsort((_to_float(fp_data["LapNumber"])[mask], drv))
        else:
            order = np.argsort(drv, kind="stable")
        names, _, starts, ends = _driver_groups(drv[order])
        lt_s = lt[order]
        result = {}
        for d, a, b in zip(names, starts, ends):
            valid = lt_s[a:b]
            valid = valid[~np.isnan(valid)]
            if valid.size == 0:
                continue
            if valid.size < 3:
                q = np.quantile(valid, 0.25)
                if not np.isnan(q):
                    result[d] = float(q)
                continue
            middle = valid[1:-1] if valid.size > 3 else valid
            if middle.size:
                result[d] = float(np.median(middle))
        default = float(np.median(list(result.values()))) if result else DEFAULT_PACE
        for driver in dict.fromkeys(drv_all):
            result.setdefault(driver, default)
        return result

    @staticmethod
    def _extract_tire_deg(fp_data: pd.DataFrame) -> dict[str, float]:
        """Per-driver linear lap-time slope, clamped [0.01, 0.15]; 0.05 for
        warming-up (negative) slopes or sparse data."""
        if fp_data.empty:
            return {}
        drv = np.asarray(fp_data["Driver"], dtype=object)
        has_lt = "LapTime" in fp_data.columns
        lt = _to_float(fp_data["LapTime"]) if has_lt else None
        if "LapNumber" in fp_data.columns:
            order = np.lexsort((_to_float(fp_data["LapNumber"]), drv))
        else:
            order = np.argsort(drv, kind="stable")
        names, _, starts, ends = _driver_groups(drv[order])
        lt_s = lt[order] if has_lt else None
        result = {}
        for d, a, b in zip(names, starts, ends):
            if b - a < 5 or not has_lt:
                result[d] = DEFAULT_DEG
                continue
            valid = lt_s[a:b]
            valid = valid[~np.isnan(valid)]
            if valid.size < 5:
                result[d] = DEFAULT_DEG
                continue
            x = np.arange(valid.size, dtype=float)
            try:
                slope = np.polyfit(x, valid, 1)[0]
                result[d] = (
                    float(np.clip(slope, 0.01, 0.15)) if slope > 0 else DEFAULT_DEG
                )
            except (np.linalg.LinAlgError, ValueError):
                result[d] = DEFAULT_DEG
        return result

    @staticmethod
    def _extract_tire_compound_deltas(fp_data: pd.DataFrame) -> dict[str, dict]:
        """Circuit-specific compound pace deltas relative to MEDIUM from
        practice, outliers beyond 107% of best removed."""
        result = {c: dict(info) for c, info in cfg.TIRE_COMPOUNDS.items()}
        if fp_data.empty or "Compound" not in fp_data.columns:
            return result
        paces = {}
        for compound in ("SOFT", "MEDIUM", "HARD"):
            laps = fp_data[fp_data["Compound"].astype(str).str.upper() == compound]
            if laps.empty or "LapTime" not in laps.columns:
                continue
            valid = laps["LapTime"].dropna()
            if len(valid) < 3:
                continue
            best = valid.min()
            representative = valid[valid < best * 1.07]
            if not representative.empty:
                paces[compound] = float(representative.median())
        if "MEDIUM" in paces:
            for compound, pace in paces.items():
                result[compound]["pace_delta"] = round(pace - paces["MEDIUM"], 2)
        return result

    # -- params assembly ---------------------------------------------------------------

    def _make_params(
        self,
        *,
        drivers: list[str],
        quali_probs: dict[str, list[float]],
        base_pace: dict[str, float],
        tire_deg: dict[str, float],
        driver_variance: dict[str, float],
        driver_dnf_rates: dict[str, float],
        circuit_info: dict,
        dynamic_compounds: dict[str, dict],
        track_condition: str,
    ) -> cfg.SimParams:
        n = len(drivers)
        grid = np.zeros((n, n), np.float32)
        for i, d in enumerate(drivers):
            probs = quali_probs.get(d) or []
            grid[i, : len(probs)] = probs[:n]
        team_rate = np.array(
            [
                cfg.DEFAULT_DNF_RATES.get(cfg.DRIVER_TEAMS.get(d, ""), 0.002)
                for d in drivers
            ],
            np.float32,
        )
        return cfg.make_sim_params(
            grid_probs=grid,
            base_pace=np.array(
                [base_pace.get(d, DEFAULT_PACE) for d in drivers], np.float32
            ),
            tire_deg=np.array(
                [tire_deg.get(d, DEFAULT_DEG) for d in drivers], np.float32
            ),
            variance=np.array(
                [driver_variance.get(d, 0.15) for d in drivers], np.float32
            ),
            dnf_rate=np.array(
                [driver_dnf_rates.get(d, team_rate[i]) for i, d in enumerate(drivers)],
                np.float32,
            ),
            team_dnf_rate=team_rate,
            pit_loss=float(circuit_info.get("pit_loss", 22.0)),
            overtake_delta=float(circuit_info.get("overtake_delta", 0.8)),
            track_condition=track_condition,
            compound_table=dynamic_compounds,
        )
