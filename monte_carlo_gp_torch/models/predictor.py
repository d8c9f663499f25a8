"""Weekend prediction orchestrator.

`F1Predictor` runs one race weekend: incremental chronological Elo builds
over (season-1, season) with the 2018 floor, FP-session fallback chains per
prediction point, actual-grid override for quali/sprint points, grid-penalty
distribution shifts, practice-data extraction of base pace / tire
degradation / circuit-specific compound deltas, clutch-factor variance
shaping with prediction-point uncertainty multipliers, team-trend and
wet-skill pace adjustments, and the Monte Carlo race simulation.

The host work (`prepare_weekend`) is pandas/numpy and produces the same
`SimParams` fields as `monte_carlo_gp_tpu.models.predictor`; the Monte Carlo
(`simulate_plan`) runs on the predictor's device, on the engine that
`resolve_engine` picks: the race kernel (the CUDA kernel for "cuda", its
plain PyTorch version for "cpu") or the lap engine, split over a mesh of
devices when it has more than one shard (`parallel/`). The lap count is a
runtime argument of the kernel, so there are no lap-count buckets, and it
runs exactly the requested number of simulations.

The qualifying grid comes from the Elo model, or from one of the two
alternative models (`quali_model="bayesian"`, whose HMC fit runs on the
predictor's device, or `"gbm"`, host code that needs scikit-learn).
"""

from __future__ import annotations

import dataclasses
import zlib
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from monte_carlo_gp_torch import config as cfg
from monte_carlo_gp_torch.data.elo_cache import load_with_priority, save_elo
from monte_carlo_gp_torch.data.loader import F1DataLoader
from monte_carlo_gp_torch.models.elo import F1EloSystem
from monte_carlo_gp_torch.models.features import F1FeatureEngine, _driver_groups, _to_float
from monte_carlo_gp_torch.models.safety import InsufficientDataError
from monte_carlo_gp_torch.ops.race_kernel import MAX_DRIVERS, run_monte_carlo_kernel_sharded
from monte_carlo_gp_torch.parallel.mesh import Mesh, resolve_mesh, run_monte_carlo_sharded
from monte_carlo_gp_torch.utils.logging import log_event
from monte_carlo_gp_torch.utils.profiling import span

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
QUALI_MODELS = ("elo", "bayesian", "gbm")


def resolve_device(device: str | torch.device) -> torch.device:
    """The device the Monte Carlo runs on. "cuda" needs a CUDA device and
    raises without one: there is no fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for, but torch.cuda.is_available() "
            "is False on this machine; pass device='cpu' to run the plain "
            "PyTorch version of the race kernel"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {str(device)!r} (use 'cuda' or 'cpu')")
    return dev


def _alt_quali_model(quali_model: str, device: torch.device):
    """The alternative qualifying model `quali_model` names, None for
    "elo". The Bayesian model fits on `device`; the gbm model raises
    ImportError naming scikit-learn where it cannot be imported."""
    if quali_model == "bayesian":
        from monte_carlo_gp_torch.models.bayesian import BayesianQualiModel

        return BayesianQualiModel(device=device)
    if quali_model == "gbm":
        from monte_carlo_gp_torch.models.ml import GBMQualiModel

        return GBMQualiModel()
    return None


ENGINES = ("auto", "xla", "pallas")


def resolve_engine(engine: str) -> str:
    """The engine policy of the CLIs and the predictor, with the JAX
    package's choices: "pallas" is the race kernels K1/K2 (the CUDA kernels
    on CUDA tensors, their plain PyTorch versions on CPU tensors), "xla" the
    lap engine (`ops/engine.py`, plain PyTorch on either device).

    "auto" resolves to "pallas" on both devices. The JAX package resolves
    it to "xla" off the TPU because its Pallas kernel has no PRNG off the
    TPU (the interpreter draws zeros); the port's plain version draws the
    kernel's own Philox stream on the CPU, so "auto" keeps every result the
    port gave before it had an engine choice."""
    if engine == "auto":
        return "pallas"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (use 'auto', 'xla' or 'pallas')")
    return engine


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


@dataclasses.dataclass(frozen=True)
class DeferredGrid:
    """A qualifying grid that waits for its Bayesian fit (`fit`, a
    `bayesian.DeferredFit`): the posterior-predictive grid of `drivers`
    (teams `driver_teams`) at `circuit` with the noise seed `seed`, then the
    grid penalties."""

    fit: object
    drivers: list[str]
    driver_teams: dict[str, str | None]
    circuit: str
    seed: int
    penalties: dict[str, int | str]


@dataclasses.dataclass(frozen=True)
class WeekendDraft:
    """A weekend prepared up to its `SimParams` (`F1Predictor.draft_weekend`):
    every host input, and the qualifying grid, or (`quali_probs` None) the
    `DeferredGrid` that gives it once the fits have run."""

    drivers: list[str]
    circuit_info: dict
    weather: dict
    prediction_point: str
    grid_is_actual: bool
    sim_inputs: dict
    quali_probs: dict[str, list[float]] | None
    grid: DeferredGrid | None = None


class F1Predictor:
    """Weekend orchestrator with the JAX package's public surface, running
    the Monte Carlo on `device` with `engine`, split over `mesh` (default:
    every visible CUDA device for "cuda", the CPU for "cpu")."""

    engine = "pallas"
    mesh: Mesh | None = None

    def __init__(
        self,
        cache_dir: str | Path = "./cache",
        offline: bool = False,
        backend=None,
        external_elo_cache: str | Path | None = None,
        use_elo_cache: bool = False,
        now: pd.Timestamp | None = None,
        device: str | torch.device = "cuda",
        rookie_prior: bool = False,
        quali_model: str = "elo",
        engine: str = "auto",
        mesh: Mesh | None = None,
    ):
        if quali_model not in QUALI_MODELS:
            raise ValueError(
                f"unknown quali_model {quali_model!r} "
                "(use 'elo', 'bayesian' or 'gbm')"
            )
        self.device = resolve_device(device)
        self._quali_model = quali_model
        # built now, so that a model that cannot run here (gbm without
        # scikit-learn) fails the construction and not a weekend
        self._bayes_model = _alt_quali_model(quali_model, self.device)
        self.engine = resolve_engine(engine)
        self.mesh = mesh
        self.data_loader = F1DataLoader(
            cache_dir=cache_dir, offline=offline, backend=backend, now=now
        )
        self.feature_engine = F1FeatureEngine(self.data_loader)
        self.elo_system = F1EloSystem()
        self._processed_seasons: set[int] = set()
        self._features_loaded = False
        self._features_now = None  # loader clock at last feature load
        self.last_effective_sims: int | None = None
        self._elo_cache_path = Path(cache_dir) / "elo_ratings.json"
        self._use_elo_cache = use_elo_cache
        self._rookie_prior = rookie_prior
        if use_elo_cache:
            loaded = load_with_priority(external_elo_cache, self._elo_cache_path)
            if loaded is not None:
                self.elo_system, seasons, _src = loaded
                self._processed_seasons = set(seasons)

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
        added = False
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
                added = True
            except Exception:  # noqa: BLE001 — a season that fails to load is skipped
                pass
        if self._use_elo_cache and added and self._processed_seasons:
            save_elo(
                self.elo_system,
                self._elo_cache_path,
                processed_seasons=sorted(self._processed_seasons),
            )
        return historical

    # -- the main pipeline -----------------------------------------------------------

    def predict_weekend(
        self,
        season: int,
        race: str,
        grid_penalties: dict[str, int | str] | None = None,
        circuit_info: dict | None = None,
        prediction_point: str = "fp2",
        actual_grid: dict[str, int] | None = None,
        n_simulations: int = 10_000,
        seed: int | None = None,
        engine: str | None = None,
        mesh: Mesh | None = None,
    ) -> dict:
        plan = self.prepare_weekend(
            season,
            race,
            grid_penalties=grid_penalties,
            circuit_info=circuit_info,
            prediction_point=prediction_point,
            actual_grid=actual_grid,
        )
        probs = self.simulate_plan(plan, n_simulations, seed, engine=engine, mesh=mesh)
        return self.assemble_result(plan, probs)

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
        CPU). Recorded as the span `weekend.prepare`, with one child per
        phase: `weekend.elo`, `weekend.archive`, `weekend.session`,
        `weekend.quali`, `weekend.practice`, `weekend.params`."""
        with span("weekend.prepare"):
            return self.finish_weekend(self._draft_weekend(
                season, race, grid_penalties, circuit_info, prediction_point, actual_grid
            ))

    @property
    def batches_fits(self) -> bool:
        """Whether a walk-forward season fits its races' qualifying models
        together (`validate/backtest.prepare_season_plans`): the Bayesian
        model, whose lone fit fills 4 of an H100's 132 SMs."""
        return self._quali_model == "bayesian"

    def draft_weekend(self, season: int, race: str) -> WeekendDraft:
        """`prepare_weekend(season, race)` up to the `SimParams`, with the
        Bayesian model's fit deferred (`fit_deferred` runs the deferred fits
        of many weekends together; `finish_weekend` then makes each plan).
        Every other input is taken now, at the loader's clock and the Elo
        state of this call, the Elo grid too where the archive cannot support
        a fit.
        The span `weekend.prepare` with `weekend.elo`, `.archive`,
        `.session`, `.quali` (the design) and `.practice` inside."""
        with span("weekend.prepare"):
            return self._draft_weekend(season, race, None, None, "fp2", None, defer=True)

    def fit_deferred(self) -> None:
        """Run the fits `draft_weekend` deferred, together (the Bayesian
        model's `fit_deferred`); nothing for another model."""
        if self._quali_model == "bayesian":
            self._bayes_model.fit_deferred()

    def _draft_weekend(
        self, season, race, grid_penalties, circuit_info, prediction_point, actual_grid,
        defer: bool = False,
    ) -> WeekendDraft:
        grid_penalties = grid_penalties or {}
        circuit_info = circuit_info or self._get_circuit_info(race)

        with span("weekend.elo"):
            historical_seasons = self._build_elo(season)
        # Features load once per loader clock, so feature inputs only see
        # races strictly before the one being predicted.
        loader_now = self.data_loader.now
        if historical_seasons and (
            not self._features_loaded or self._features_now != loader_now
        ):
            with span("weekend.archive"):
                self.feature_engine.load_historical_data(historical_seasons)
            self._features_loaded = True
            self._features_now = loader_now

        with span("weekend.session"):
            fp_data, weather = self._practice_session(season, race, prediction_point)
            drivers = fp_data["Driver"].unique().tolist()
            # The weekend's driver→team assignment comes from the session
            # frame; the static 2025 map is only the fallback for rows
            # without a Team.
            weekend_teams = self._teams_from_fp(fp_data, drivers)

        with span("weekend.quali"):
            quali_probs, grid = self._quali_probs(
                season, race, drivers, weekend_teams, grid_penalties,
                prediction_point, actual_grid, defer,
            )

        with span("weekend.practice"):
            sim_inputs = self._practice_inputs(fp_data, drivers, race, weather,
                                               circuit_info, prediction_point)
        return WeekendDraft(
            drivers=drivers,
            circuit_info=circuit_info,
            weather=weather,
            prediction_point=prediction_point,
            # an empty dict must not label a model-predicted grid as actual
            grid_is_actual=bool(actual_grid)
            and prediction_point in ("quali", "sprint"),
            sim_inputs=sim_inputs,
            quali_probs=quali_probs,
            grid=grid,
        )

    def finish_weekend(self, draft: WeekendDraft) -> WeekendPlan:
        """The plan of a drafted weekend, once its fit has run: the grid
        from the posterior where it waited for the fit (the span
        `weekend.quali`), and the `SimParams` (`weekend.params`)."""
        quali_probs = draft.quali_probs
        if quali_probs is None:
            with span("weekend.quali"):
                quali_probs = self._deferred_quali_probs(draft.grid)
        with span("weekend.params"):
            params = self._make_params(
                drivers=draft.drivers,
                quali_probs=quali_probs,
                circuit_info=draft.circuit_info,
                **draft.sim_inputs,
            )
        return WeekendPlan(
            params=params,
            total_laps=int(draft.circuit_info.get("laps", 58)),
            drivers=draft.drivers,
            quali_probs=quali_probs,
            weather=draft.weather,
            prediction_point=draft.prediction_point,
            grid_is_actual=draft.grid_is_actual,
        )

    def _practice_session(self, season: int, race: str, prediction_point: str):
        """(the first non-empty practice session of the point's fallback
        chain, the race's weather); raises InsufficientDataError when every
        session is empty."""
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
        return fp_data, weather

    def _quali_probs(self, season, race, drivers, weekend_teams, grid_penalties,
                     prediction_point, actual_grid, defer: bool = False):
        """(each driver's qualifying position distribution, None): the actual
        grid, or the qualifying model's (with opt-in rookie seeding first),
        then the grid penalties. With `defer` and the Bayesian model, a grid
        that needs the model's fit is (None, its `DeferredGrid`)."""
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
                if defer and self._quali_model == "bayesian":
                    grid = self._defer_quali_alt(drivers, circuit, season, weekend_teams,
                                                 grid_penalties)
                    if grid is not None:
                        return None, grid
                else:
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
        return quali_probs, None

    def _practice_inputs(self, fp_data, drivers, race, weather, circuit_info,
                         prediction_point) -> dict:
        """The Monte Carlo's per-driver inputs from the practice session and
        the race features: pace (with team-trend and wet-skill
        adjustments), tyre degradation, compound deltas, variance, DNF
        rates, and the track condition; `_make_params`' keyword arguments."""
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
        return {
            "base_pace": base_pace,
            "tire_deg": tire_deg,
            "driver_variance": driver_variance,
            "driver_dnf_rates": driver_dnf_rates,
            "dynamic_compounds": dynamic_compounds,
            "track_condition": track_condition,
        }

    def simulate_plan(
        self,
        plan: WeekendPlan,
        n_simulations: int,
        seed: int | None = None,
        engine: str | None = None,
        mesh: Mesh | None = None,
    ) -> np.ndarray:
        """Run the Monte Carlo for a prepared weekend on the predictor's
        device; returns the (D, D) finish-probability matrix. `seed=None`
        means 0; `engine` and `mesh` override the predictor's for this call.

        "pallas" runs fields of up to MAX_DRIVERS (128) drivers on the race
        kernel, `run_monte_carlo_kernel_sharded`: one launch per shard of
        the mesh (the JAX package's predictor.py:457-492, which takes the
        unsplit launch on one device only because `shard_map` needs a mesh
        of several). Its rank keys pack rank*M+row (M = 32/64/128 by field
        size), which caps the driver axis at 128; the reference simulator is
        size-generic (simulation.py:59-100), so wider fields run on the lap
        engine, as "xla" does, and log `engine_fallback_eager` (the JAX
        package's `engine_fallback_xla`, predictor.py:444-456). The lap
        engine is split the same way (`run_monte_carlo_sharded`, any
        simulation count; the JAX package runs it unsplit, which gives the
        same bits). Every route gives bitwise the same result for any mesh;
        a kernel error raises."""
        n = int(n_simulations)
        seed = 0 if seed is None else seed
        engine = resolve_engine(engine) if engine else self.engine
        mesh = resolve_mesh(mesh if mesh is not None else self.mesh, self.device)
        with span("weekend.simulate"):
            probs = self._simulate(plan, n, seed, engine, mesh)
        self.last_effective_sims = n
        return probs

    def _simulate(self, plan: WeekendPlan, n: int, seed: int, engine: str, mesh) -> np.ndarray:
        with span("simulate.upload"):
            params = plan.params.to(self.device)
        if engine == "pallas" and params.n_drivers > MAX_DRIVERS:
            log_event(
                "engine_fallback_eager",
                reason=f"n_drivers>{MAX_DRIVERS} exceeds the race kernel's rank-key packing",
                n_drivers=params.n_drivers,
            )
            engine = "xla"
        with span("simulate.launch"):
            if engine == "pallas":
                probs = run_monte_carlo_kernel_sharded(params, seed, n, plan.total_laps, mesh)
            else:
                probs = run_monte_carlo_sharded(params, seed, n, plan.total_laps, mesh)
        with span("simulate.readback"):
            return probs.cpu().numpy()

    def assemble_result(self, plan: WeekendPlan, probs: np.ndarray) -> dict:
        """The result dict from a (D, D) finish-probability matrix (the span
        `weekend.assemble`)."""
        with span("weekend.assemble"):
            return self._assemble(plan, probs)

    def _assemble(self, plan: WeekendPlan, probs: np.ndarray) -> dict:
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
            return self._alt_fallback("empty_archive", race)
        noise_seed = zlib.crc32(f"{season}:{race}".encode())
        if driver_teams is None:
            driver_teams = {d: cfg.DRIVER_TEAMS.get(d) for d in drivers}
        try:
            return self._bayes_model.predict(
                laps, drivers, driver_teams, circuit=race, seed=noise_seed
            )
        except ValueError as e:
            return self._alt_fallback(str(e), race)

    def _alt_fallback(self, reason: str, race: str) -> None:
        """Log why the alternative model gives no grid (the Elo grid is
        taken instead)."""
        log_event("alt_quali_fallback", model=self._quali_model, reason=reason, race=race)

    def _defer_quali_alt(
        self, drivers: list[str], race: str, season: int, driver_teams: dict[str, str | None],
        penalties: dict[str, int | str],
    ) -> DeferredGrid | None:
        """`_predict_quali_alt` of the Bayesian model with its fit deferred
        (`BayesianQualiModel.defer`): the grid's `DeferredGrid`, or None,
        logged, where the archive cannot support a fit, decided now as
        `_predict_quali_alt` decides it."""
        laps = self.feature_engine.laps
        if laps.empty:
            return self._alt_fallback("empty_archive", race)
        try:
            fit = self._bayes_model.defer(laps)
        except ValueError as e:
            return self._alt_fallback(str(e), race)
        return DeferredGrid(fit, drivers, driver_teams, race,
                            zlib.crc32(f"{season}:{race}".encode()), penalties)

    def _deferred_quali_probs(self, grid: DeferredGrid) -> dict[str, list[float]]:
        """The grid of a `DeferredGrid` whose fit has run, as
        `_predict_quali_alt` and the grid penalties give it."""
        from monte_carlo_gp_torch.models.bayesian import quali_position_probs

        if grid.fit.posterior is None:
            raise RuntimeError("the weekend's Bayesian fit has not run (fit_deferred)")
        probs = quali_position_probs(grid.fit.posterior, grid.drivers, grid.driver_teams,
                                     grid.circuit, grid.seed)
        if grid.penalties:
            probs = self._adjust_for_penalties(probs, grid.penalties)
        return probs

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
