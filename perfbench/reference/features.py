"""Feature engineering over historical lap archives.

Capability-parity rebuild of the reference `F1FeatureEngine`
(reference src/features.py): 8 qualifying features and 10 race
features with the same formulas, clamps and defaults (SURVEY.md §2 row 6).

Design differences (all deliberate):
  * every feature is computed for ALL drivers at once with vectorized pandas
    groupbys over precomputed aggregate tables (the reference re-groups the
    whole archive per driver per feature — O(drivers × features) scans);
  * results are exposed both as the reference's per-driver dicts
    (`calculate_quali_features` / `calculate_race_features`) and as dense
    feature tensors for the predictor (`quali_feature_arrays` /
    `race_feature_arrays`);
  * `teammate_delta` is computed over the full archive. In the reference the
    feature is structurally dead: `calculate_quali_features` passes only the
    driver's own laps into `_calc_teammate_delta` (features.py:81-88), so no
    teammate rows exist and it always returns 0.0;
  * `avg_gap_to_pole_pct` is actually computed (the reference stubs it to a
    constant 1.0, features.py:128-133);
  * `circuit_affinity` matches archive events by short circuit name
    ('Bahrain' ⊂ 'Bahrain Grand Prix'). The reference matches raw labels
    (`features.py:205-209`): its archive stores full event names while the
    similarity table holds short names, so the isin() never matches and the
    feature is 0.0 in practice;
  * the reference's RECENT_LAPS=100 qualifying window (features.py:76-84) is
    consumed ONLY by the gap-to-pole stub (1.0 vs 1.5 branch) and the dead
    teammate feature, so it has no live effect to reproduce — measured by
    tests/test_reference_ab.py.

`reference_compat=True` reproduces the reference's literal behavior for all
three divergent features (for A/B validation against the real code).

Everything here is off the hot path; outputs become torch tensors at the
predictor boundary.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from perfbench.reference import config as cfg

SESSION_KEY = ["season", "circuit", "session_type"]


def _safe_div(a, b, default=0.0):
    return a / b if b else default


class F1FeatureEngine:
    """Same public surface as the reference (features.py:10-126)."""

    def __init__(self, data_loader, reference_compat: bool = False):
        self.loader = data_loader
        self.laps = pd.DataFrame()
        self.race_results = pd.DataFrame()
        self._tables: dict | None = None
        self.reference_compat = reference_compat
        # per-(season, event, session) annotated frames: event data is
        # immutable, so walk-forward rebuilds (one per race) only annotate
        # events they have not seen before
        self._annotated: dict[tuple, pd.DataFrame] = {}
        # ordered (season, name, sessions) list of the events in the current
        # archive, and the per-event aggregate partials memoized across
        # walk-forward rebuilds (see _event_partial)
        self._events: list[tuple] = []
        self._event_parts: dict[tuple, dict] = {}

    # -- loading (reference features.py:16-72) --------------------------------

    def load_historical_data(self, seasons: list[int]) -> None:
        """Combine Q+R laps and race classifications across seasons."""
        all_laps, all_results = [], []
        self._events = []
        for season in seasons:
            for ev in self.loader.past_events(season):
                name = ev["EventName"]
                frames = []
                for session_type in ("Q", "R"):
                    key = ("laps", season, name, session_type)
                    cached = self._annotated.get(key)
                    if cached is None:
                        laps = self.loader.load_session(season, name, session_type)
                        if laps.empty:
                            continue
                        cached = laps.assign(
                            season=season, circuit=name, session_type=session_type
                        )
                        self._annotated[key] = cached
                    all_laps.append(cached)
                    frames.append(session_type)
                if frames:
                    self._events.append((season, name, tuple(frames)))
                key = ("results", season, name)
                res = self._annotated.get(key)
                if res is None:
                    raw = self.loader.load_results(season, name, "R")
                    if raw is not None and not raw.empty:
                        res = raw.rename(
                            columns={
                                "Abbreviation": "driver",
                                "GridPosition": "grid",
                                "Position": "finish",
                                "Status": "status",
                            }
                        )[["driver", "grid", "finish", "status"]].assign(
                            season=season, circuit=name
                        )
                        self._annotated[key] = res
                if res is not None:
                    all_results.append(res)
        self.laps = (
            pd.concat(all_laps, ignore_index=True) if all_laps else pd.DataFrame()
        )
        # marks the archive as loader-built so _t() may use the memoized
        # per-event partials. An unforgeable token carried on the frame's
        # attrs (not id(): CPython reuses ids after GC, so a replacement
        # frame could collide and silently reuse stale partials) — a
        # directly-assigned `laps` frame can never satisfy the guard.
        self._laps_token = object()
        self.laps.attrs["_mcgp_loader_token"] = self._laps_token
        self.race_results = (
            pd.concat(all_results, ignore_index=True)
            if all_results
            else pd.DataFrame()
        )
        self._tables = None

    # -- aggregate tables (computed once per archive) --------------------------

    def _t(self) -> dict:
        if self._tables is not None:
            return self._tables
        t: dict = {}
        if not self.race_results.empty:
            # per-driver numpy bundles for the result-based race features:
            # (grid, finish, is_dnf, season) in archive row order. The seven
            # per-driver feature getters were each slicing/masking a pandas
            # frame per (driver, race) call — ~2-4 ms of frame overhead per
            # call dominated season host prep after the lap tables were
            # memoized. Same values, same order, numpy ops instead.
            rr = self.race_results
            status = rr["status"].astype(str).str.lower()
            is_dnf = ~(
                status.str.contains("finished")
                | status.str.contains(r"\+", regex=True)
            ).to_numpy(bool)
            grid = rr["grid"].to_numpy(float)
            finish = rr["finish"].to_numpy(float)
            seas = (
                rr["season"].to_numpy() if "season" in rr.columns else None
            )
            t["results_np"] = {
                d: (
                    grid[ix],
                    finish[ix],
                    is_dnf[ix],
                    seas[ix] if seas is not None else None,
                )
                for d, ix in rr.groupby("driver", sort=False).indices.items()
            }
        laps = self.laps
        if laps.empty or "Driver" not in laps.columns:
            self._tables = t
            return t
        # Event-level tables (season, circuit), combining Q+R sessions — the
        # reference groups `self.laps` by (season, circuit) for sector
        # strength, wet performance and temp sensitivity (features.py:292,
        # :650, :745), so one entry per EVENT, not per session.
        #
        # ASSEMBLED FROM MEMOIZED PER-EVENT PARTIALS: the walk-forward
        # backtest pins the loader clock and rebuilds the archive once per
        # race, so the archive is APPEND-ONLY — every per-event aggregate
        # for an already-seen event is bit-identical across rebuilds.
        # Whole-archive groupbys (dominated by pyarrow-string `take`) made
        # table rebuilds ~half of season host prep; computing each event's
        # partial once (keyed by (season, name, sessions)) and concatenating
        # makes rebuild k cost O(1 new event). Per-group aggregates
        # (min/median/count/any/first/slopes) are bitwise what the global
        # groupby produced (same rows, same order); only the cross-event
        # accumulations (drv_lap_sum / drv_circuit_sum) change float
        # association — orders of magnitude below the 1e-9 A/B tolerance
        # (tests/test_reference_ab.py) and deterministic (fixed event
        # order). Equality with a from-scratch engine is pinned by
        # tests/test_features.py::test_event_partial_memo_matches_fresh.
        parts = []
        if (
            getattr(self, "_laps_token", None) is not None
            and laps.attrs.get("_mcgp_loader_token") is self._laps_token
        ):
            # archive built by load_historical_data: events known, partials
            # memoized across walk-forward rebuilds
            for season, name, sessions in self._events:
                key = (season, name, sessions)
                p = self._event_parts.get(key)
                if p is None:
                    frames = [
                        self._annotated[("laps", season, name, st)]
                        for st in sessions
                    ]
                    ev = (
                        pd.concat(frames, ignore_index=True)
                        if len(frames) > 1
                        else frames[0]
                    )
                    p = _event_partial(ev)
                    self._event_parts[key] = p
                parts.append(((season, name), p))
        else:
            # `laps` assigned directly (tests, A/B harnesses): derive events
            # from the frame in first-appearance order — the same group rows
            # in the same relative order the whole-archive groupbys saw.
            for key, ev in laps.groupby(["season", "circuit"], sort=False):
                parts.append((tuple(key), _event_partial(ev)))

        # ---- accumulate the whole-field tables from the partials ----------
        # Every table is a plain dict built by merging per-event pieces in
        # SORTED (season, circuit) order — the same row order the old
        # whole-archive groupby/pivot versions reduced in, so per-driver
        # means/fits see identical values in identical order. (The round-1
        # profile that motivated whole-field tables: _teammate_delta 34s +
        # _quali_gaps 36s per season of per-driver rescans; the pandas
        # assembly that replaced them was itself ~60% of the memoized
        # rebuild, hence this final dict form.) Guarded field-by-field vs
        # the genuine reference engine at rel 1e-9
        # (tests/test_reference_ab.py) and memo-vs-fresh
        # (tests/test_features.py).
        sparts = sorted(parts, key=lambda kp: kp[0])

        deg_vals: dict = {}
        q_gap_lists: dict = {}
        tm_sum: dict = {}
        tm_cnt: dict = {}
        sector_lists: dict = {c: {} for c in
                              ("Sector1Time", "Sector2Time", "Sector3Time")}
        wet_lists: dict = {}
        dry_lists: dict = {}
        temp_pts: dict = {}
        rp_lists: dict = {}
        any_deg = any_q = any_tm = any_wet = any_temp = False
        any_sector = {c: False for c in sector_lists}
        for _, p in sparts:
            # deg rate (reference features.py:448-490): dropna, keep
            # slopes in (0, 0.5); mean clamped below
            if "deg" in p:
                any_deg = True
                for drv, v in p["deg"].items():
                    if not pd.isna(v) and 0.0 < v < 0.5:
                        deg_vals.setdefault(drv, []).append(v)
            if "q_gaps" in p:
                any_q = True
                for drv, v in p["q_gaps"].items():
                    q_gap_lists.setdefault(drv, []).append(v)
            if "tm_cnt" in p:
                any_tm = True
                for drv, v in p["tm_sum"].items():
                    tm_sum[drv] = tm_sum.get(drv, 0.0) + v
                    tm_cnt[drv] = tm_cnt.get(drv, 0) + p["tm_cnt"][drv]
            for col, lists in sector_lists.items():
                piece = p.get("sector_gap_" + col)
                if piece is not None:
                    any_sector[col] = True
                    for drv, v in piece.items():
                        if np.isfinite(v):
                            lists.setdefault(drv, []).append(v)
            gaps = p.get("ev_gap")
            if gaps:
                # wet flag defaults False for events without a Rainfall
                # column (the old reindex(...).fillna(False))
                if "wet" in p:
                    any_wet = True
                target = wet_lists if p.get("wet", False) else dry_lists
                for drv, v in gaps.items():
                    target.setdefault(drv, []).append(v)
                temp = p.get("temp")
                if temp is not None:
                    any_temp = True
                    if not pd.isna(temp) and p["ev_best"] > 0:
                        for drv, v in gaps.items():
                            temp_pts.setdefault(drv, []).append((temp, v))
            rp = p.get("rp_delta")
            if rp:
                for drv, v in rp.items():
                    rp_lists.setdefault(drv, []).append(v)

        if any_deg:
            t["deg_rate_all"] = {
                drv: float(np.clip(np.mean(vals), 0.01, 0.15))
                for drv, vals in deg_vals.items()
            }
        if any_q:
            t["q_gaps_np"] = {
                drv: np.asarray(vals, float)
                for drv, vals in q_gap_lists.items()
            }
        if any_tm:
            t["teammate_delta_all"] = {
                drv: float(tm_sum[drv] / tm_cnt[drv]) for drv in tm_cnt
            }
        for col, lists in sector_lists.items():
            if any_sector[col]:
                t["sector_strength_" + col] = {
                    drv: float(np.clip(np.mean(vals), -1.0, 1.0))
                    for drv, vals in lists.items()
                    if vals
                }
        if any_wet:
            out = {}
            # sorted(): never iterate a raw set (PYTHONHASHSEED order —
            # a repository invariant; values here are order-independent today,
            # but table ORDER must stay reproducible for any consumer).
            for drv in sorted(set(wet_lists) | set(dry_lists)):
                wg, dg = wet_lists.get(drv), dry_lists.get(drv)
                if wg and dg:
                    out[drv] = float(
                        np.clip(np.mean(dg) - np.mean(wg), -1.0, 1.0)
                    )
            t["wet_performance_all"] = out
        if any_temp:
            out = {}
            for drv, pts in temp_pts.items():
                tk = np.asarray([a for a, _ in pts], float)
                gk = np.asarray([b for _, b in pts], float)
                if len(gk) >= 5 and tk.std() >= 5:
                    slope = np.polyfit(tk, gk, 1)[0]
                    out[drv] = float(np.clip(slope / 100.0, 0.0, 0.005))
            t["temp_sensitivity_all"] = out
        if rp_lists:
            t["race_pace_by_driver"] = {
                drv: float(np.mean(vals)) for drv, vals in rp_lists.items()
            }
        # per-driver lap-time sums/counts overall and per short circuit name
        # (circuit affinity = mean over laps, reference features.py:214-234)
        lap_sum, lap_n = {}, {}
        circ_sum, circ_n = {}, {}
        for (season, name), p in parts:
            short = _short_name(name)
            for drv, v in p["lap_sum"].items():
                lap_sum[drv] = lap_sum.get(drv, 0.0) + v
                circ_sum[(drv, short)] = circ_sum.get((drv, short), 0.0) + v
            for drv, n_ in p["lap_n"].items():
                lap_n[drv] = lap_n.get(drv, 0) + n_
                circ_n[(drv, short)] = circ_n.get((drv, short), 0) + n_
        if lap_sum:
            t["drv_lap_sum"] = lap_sum
            t["drv_lap_n"] = lap_n
            t["drv_circuit_sum"] = circ_sum
            t["drv_circuit_n"] = circ_n
        # Q3-rate heuristic: share of Q sessions with >=3 laps per driver —
        # a ratio of counts (mean of booleans == hits/total exactly,
        # reference features.py:236-259)
        q3_hits: dict = {}
        q3_total: dict = {}
        for _, p in parts:
            for (drv, st), n_ in p["nlaps"].items():
                if st == "Q":
                    q3_total[drv] = q3_total.get(drv, 0) + 1
                    q3_hits[drv] = q3_hits.get(drv, 0) + (1 if n_ >= 3 else 0)
        if q3_total:
            t["q3_rate_all"] = {
                drv: q3_hits[drv] / q3_total[drv] for drv in q3_total
            }
        self._tables = t
        return t

    # -- public per-driver API (reference features.py:74-126) ------------------

    def calculate_quali_features(self, driver: str, circuit: str) -> dict:
        if self.reference_compat:
            return {
                # Reference stub (features.py:128-133): 1.0 whenever the
                # driver has any recent Q laps, 1.5 otherwise. The tail(100)
                # window cannot change emptiness, so "any Q laps" is exact.
                "avg_gap_to_pole_pct": (
                    1.0
                    if not self.laps.empty
                    and (
                        (self.laps["Driver"] == driver)
                        & (self.laps["session_type"] == "Q")
                    ).any()
                    else 1.5
                ),
                # Dead in the reference: only the driver's own laps reach
                # _calc_teammate_delta (features.py:81-88).
                "teammate_delta": 0.0,
                "circuit_affinity": self._circuit_affinity_compat(driver, circuit),
                "q3_conversion": self._q3_rate(driver),
                "low_speed_strength": self._sector_strength(driver, "low_speed"),
                "high_speed_strength": self._sector_strength(driver, "high_speed"),
                "traction_strength": self._sector_strength(driver, "traction"),
                "form_score": self._form_score(driver),
            }
        return {
            "avg_gap_to_pole_pct": self._gap_to_pole(driver),
            "teammate_delta": self._teammate_delta(driver),
            "circuit_affinity": self._circuit_affinity(driver, circuit),
            "q3_conversion": self._q3_rate(driver),
            "low_speed_strength": self._sector_strength(driver, "low_speed"),
            "high_speed_strength": self._sector_strength(driver, "high_speed"),
            "traction_strength": self._sector_strength(driver, "traction"),
            "form_score": self._form_score(driver),
        }

    def calculate_race_features(self, driver: str, circuit: str, weather: dict) -> dict:
        rainfall = weather.get("rainfall", False)
        if pd.isna(rainfall):
            is_wet = False
        elif isinstance(rainfall, bool):
            is_wet = rainfall
        elif isinstance(rainfall, (int, float)):
            is_wet = rainfall > 0
        else:
            is_wet = str(rainfall).lower() in ("true", "yes", "1")
        track_temp = weather.get("track_temp", 35)
        track_temp = float(track_temp) if pd.notna(track_temp) else 35.0
        return {
            "race_pace_delta": self._race_pace(driver),
            "deg_rate": self._deg_rate(driver),
            "overtake_rate": self._overtake_rate(driver),
            "position_hold_rate": self._defense_rate(driver),
            "dnf_probability": self._dnf_prob(driver),
            "start_delta": self._start_performance(driver),
            "clutch_factor": self._clutch_factor(driver),
            "wet_performance": self._wet_performance(driver) if is_wet else 0,
            "high_temp_deg": self._temp_sensitivity(driver) * track_temp,
            "team_trend": self._team_trend(driver),
        }

    # -- qualifying features ----------------------------------------------------

    def _gap_to_pole(self, driver: str) -> float:
        """Mean % gap to pole in qualifying. Reference stubs this to 1.0 with
        a 1.5 empty-default (features.py:128-133); here it is computed."""
        gaps = self._t().get("q_gaps_np", {}).get(driver)
        if gaps is None or not gaps.size:
            return 1.5
        return float(gaps.mean())

    def _teammate_delta(self, driver: str) -> float:
        """Mean % best-lap delta vs teammate per (season, circuit) session
        (features.py:135-185 intent; see module docstring on the reference's
        dead-code form). Positive = faster than teammate. Teammates are
        matched per event, so team changes between seasons compare against
        the right car in each season. Computed for the whole field at once
        in `_t()` ('teammate_delta_all')."""
        t = self._t()
        if not t or "teammate_delta_all" not in t:
            return 0.0
        return t["teammate_delta_all"].get(driver, 0.0)

    def _circuit_affinity(self, driver: str, circuit: str) -> float:
        """Mean lap time at this circuit type vs overall, normalized and
        clamped to ±0.5 (features.py:187-234)."""
        t = self._t()
        if not t or "drv_lap_n" not in t:
            return 0.0
        n_all = t["drv_lap_n"].get(driver, 0)
        if not n_all:
            return 0.0
        # sorted: the accumulation below is float addition in iteration
        # order; a raw set's hash-randomized order would make the feature
        # vary in the last ULP across processes.
        targets = sorted(
            {_short_name(circuit)} | set(cfg.get_similar_tracks(_short_name(circuit)))
        )
        sums = t["drv_circuit_sum"]
        counts = t["drv_circuit_n"]
        total = n = 0.0
        for short in targets:
            key = (driver, short)
            if key in counts:
                total += sums[key]
                n += counts[key]
        if n == 0:
            return 0.0
        circuit_avg = total / n
        overall_avg = t["drv_lap_sum"][driver] / n_all
        if overall_avg == 0:
            return 0.0
        return float(np.clip((overall_avg - circuit_avg) / overall_avg, -0.5, 0.5))

    def _circuit_affinity_compat(self, driver: str, circuit: str) -> float:
        """The reference's literal circuit-affinity computation
        (features.py:187-234): archive rows matched by RAW circuit label
        against [circuit] + similar short names. Because the archive stores
        full event names, this is 0.0 for short-name inputs — kept only for
        A/B validation; the default path fixes the matching."""
        if self.laps.empty or "LapTime" not in self.laps.columns:
            return 0.0
        mine = self.laps[self.laps["Driver"] == driver]
        if mine.empty:
            return 0.0
        targets = [circuit] + cfg.get_similar_tracks(circuit)
        at_circuit = mine[mine["circuit"].isin(targets)]
        circuit_avg = at_circuit["LapTime"].dropna().mean()
        overall_avg = mine["LapTime"].dropna().mean()
        if pd.isna(circuit_avg) or pd.isna(overall_avg) or overall_avg == 0:
            return 0.0
        return float(
            np.clip((overall_avg - circuit_avg) / overall_avg, -0.5, 0.5)
        )

    def _q3_rate(self, driver: str) -> float:
        """Share of Q sessions with >=3 laps — the reference's Q3 heuristic
        (features.py:236-259). Whole-field table from `_t()`."""
        t = self._t()
        if not t or "q3_rate_all" not in t:
            return 0.5
        return float(t["q3_rate_all"].get(driver, 0.5))

    def _sector_strength(self, driver: str, sector_type: str) -> float:
        """% advantage vs session best in the mapped sector, mean over all
        sessions, clamped ±1 (features.py:261-320)."""
        col = {
            "high_speed": "Sector1Time",
            "low_speed": "Sector2Time",
            "traction": "Sector3Time",
        }.get(sector_type, "Sector1Time")
        t = self._t()
        if not t or ("sector_strength_" + col) not in t:
            return 0.0
        return t["sector_strength_" + col].get(driver, 0.0)

    def _form_score(self, driver: str, decay: float = 0.85) -> float:
        """Exponential-decay weighted recent qualifying form in [-1, 1]
        (features.py:322-394): per Q session, score = clip(1 - gap%, -1, 1),
        weight = decay^(sessions_ago)."""
        gaps = self._t().get("q_gaps_np", {}).get(driver)
        if gaps is None or not gaps.size:
            return 0.0
        scores = np.clip(1.0 - gaps, -1.0, 1.0)
        n = len(scores)
        weights = decay ** (n - 1 - np.arange(n))
        return float((scores * weights).sum() / weights.sum())

    # -- race features ------------------------------------------------------------

    def _race_pace(self, driver: str) -> float:
        """Mean % gap of driver's median race lap to the fastest qualifying
        (>=5 laps) median in each race (features.py:396-446). Whole-field
        table precomputed in `_t()`."""
        t = self._t()
        if not t or "race_pace_by_driver" not in t:
            return 0.0
        return float(t["race_pace_by_driver"].get(driver, 0.0))

    def _deg_rate(self, driver: str) -> float:
        """Linear lap-time slope per race session, outliers ±10s of median
        removed, slopes kept in (0, 0.5), mean clamped [0.01, 0.15]
        (features.py:448-490). Folded per driver once per archive."""
        t = self._t()
        if not t or "deg_rate_all" not in t:
            return 0.05
        return t["deg_rate_all"].get(driver, 0.05)

    _EMPTY_BUNDLE = (np.empty(0), np.empty(0), np.empty(0, bool), None)

    def _result_arrays(self, driver: str):
        """(grid, finish, is_dnf, season) numpy arrays in archive row order
        for the seven result-based features (same rows, same order as the
        reference's per-driver frame rescans, without per-call slicing)."""
        return self._t().get("results_np", {}).get(driver, self._EMPTY_BUNDLE)

    def _overtake_rate(self, driver: str) -> float:
        """Mean grid - finish (features.py:492-514)."""
        grid, finish, _, _ = self._result_arrays(driver)
        m = (grid > 0) & (finish > 0)
        if not m.any():
            return 0.0
        return float((grid[m] - finish[m]).mean())

    def _defense_rate(self, driver: str) -> float:
        """Share of races finishing within one place of grid, clamped
        [0.3, 0.95] (features.py:516-543)."""
        grid, finish, _, _ = self._result_arrays(driver)
        if len(grid) < 3:
            return 0.7
        m = (grid > 0) & (finish > 0)
        if not m.any():
            return 0.7
        held = (finish[m] <= grid[m] + 1).mean()
        return float(np.clip(held, 0.3, 0.95))

    def _dnf_prob(self, driver: str) -> float:
        """Historical per-race DNF rate from status strings, clamped
        [0.01, 0.20] (features.py:545-566)."""
        grid, _, is_dnf, _ = self._result_arrays(driver)
        if len(grid) < 5:
            return 0.05
        return float(np.clip(is_dnf.mean(), 0.01, 0.20))

    def _start_performance(self, driver: str) -> float:
        """40% of grid-to-finish gains in point-scoring races, clamped ±3
        (features.py:568-594)."""
        grid, finish, _, _ = self._result_arrays(driver)
        if len(grid) < 5:
            return 0.0
        m = (grid > 0) & (finish > 0) & (finish <= 15)
        if not m.any():
            return 0.0
        avg = ((grid[m] - finish[m]) * 0.4).mean()
        return float(np.clip(avg, -3.0, 3.0))

    def _clutch_factor(self, driver: str) -> float:
        """Normalized outperformance from contested grid slots (2-10),
        clamped ±0.5 (features.py:596-624)."""
        grid, finish, _, _ = self._result_arrays(driver)
        if len(grid) < 10:
            return 0.0
        m = (grid >= 2) & (grid <= 10) & (finish > 0)
        if not m.any():
            return 0.0
        avg = ((grid[m] - finish[m]) / 5.0).mean()
        return float(np.clip(avg, -0.5, 0.5))

    def _wet_performance(self, driver: str) -> float:
        """Gap-to-session-best difference, dry minus wet sessions, clamped ±1
        (features.py:626-685). Positive = relatively faster in the wet."""
        t = self._t()
        if not t or "wet_performance_all" not in t:
            return 0.0
        return t["wet_performance_all"].get(driver, 0.0)

    def _team_trend(self, driver: str, recent_races: int = 5) -> float:
        """Last-5 vs earlier-season average finish, normalized /10, clamped
        ±0.5 (features.py:687-728)."""
        _, finish, _, seas = self._result_arrays(driver)
        if seas is None or not len(finish):
            return 0.0
        fin = finish[seas == seas.max()]
        if len(fin) < recent_races + 2:
            return 0.0
        recent = fin[-recent_races:]
        recent = recent[~np.isnan(recent)]
        earlier = fin[: len(fin) - recent_races]
        earlier = earlier[~np.isnan(earlier)]
        if not recent.size or not earlier.size:
            return 0.0
        return float(np.clip((earlier.mean() - recent.mean()) / 10.0, -0.5, 0.5))

    def _temp_sensitivity(self, driver: str) -> float:
        """Slope of gap% vs session track temperature, /100, clamped
        [0, 0.005] (features.py:730-786)."""
        t = self._t()
        if not t or "temp_sensitivity_all" not in t:
            return 0.001
        return t["temp_sensitivity_all"].get(driver, 0.001)

    # -- dense tensors for the predictor ----------------------------------------

    QUALI_KEYS = (
        "avg_gap_to_pole_pct", "teammate_delta", "circuit_affinity",
        "q3_conversion", "low_speed_strength", "high_speed_strength",
        "traction_strength", "form_score",
    )
    RACE_KEYS = (
        "race_pace_delta", "deg_rate", "overtake_rate", "position_hold_rate",
        "dnf_probability", "start_delta", "clutch_factor", "wet_performance",
        "high_temp_deg", "team_trend",
    )

    def quali_feature_arrays(self, drivers: list[str], circuit: str) -> dict[str, np.ndarray]:
        rows = [self.calculate_quali_features(d, circuit) for d in drivers]
        return {
            k: np.array([r[k] for r in rows], np.float32) for k in self.QUALI_KEYS
        }

    def race_feature_arrays(
        self, drivers: list[str], circuit: str, weather: dict
    ) -> dict[str, np.ndarray]:
        rows = [self.calculate_race_features(d, circuit, weather) for d in drivers]
        return {
            k: np.array([r[k] for r in rows], np.float32) for k in self.RACE_KEYS
        }


def _to_float(col: pd.Series) -> np.ndarray:
    """Dense float64 view of a (possibly arrow-backed) numeric column."""
    return col.to_numpy(dtype=float, na_value=np.nan)


def _driver_groups(drv: np.ndarray):
    """Sorted-driver group runs: (unique sorted names, order, starts, ends).
    `order` is a STABLE argsort, so rows within a group keep their original
    relative order — the same per-group row order pandas groupby exposes."""
    order = np.argsort(drv, kind="stable")
    d_sorted = drv[order]
    if len(d_sorted) == 0:
        return [], order, np.empty(0, int), np.empty(0, int)
    change = np.nonzero(d_sorted[1:] != d_sorted[:-1])[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(d_sorted)]])
    return list(d_sorted[starts]), order, starts, ends


def _group_min(vals_sorted: np.ndarray, starts, ends) -> list:
    """Per-group NaN-skipping min (NaN when the whole group is NaN) —
    exactly pandas groupby.min()."""
    return [
        (np.fmin.reduce(vals_sorted[a:b]) if b > a else np.nan)
        for a, b in zip(starts, ends)
    ]


def _event_partial(ev: pd.DataFrame) -> dict:
    """All per-event pieces of the `_t()` tables for one event's combined
    Q+R laps frame — computed ONCE per event and memoized across
    walk-forward rebuilds (the archive is append-only under the pinned
    clock, so event data is immutable). Emits the event's DERIVED
    contributions (gaps, teammate pair deltas, race-pace deltas, deg
    slopes) as plain dicts, so a table rebuild is pure dict accumulation:
    every aggregate below acts on the same rows, in the same order, with
    the same formula as the whole-archive pandas version it replaced —
    values are bitwise identical per event; only the cross-event float
    accumulation order can differ (far below the 1e-9 reference-A/B
    tolerance, and deterministic).

    Implemented as ONE column-to-numpy conversion + stable-sorted group
    runs instead of ~12 pandas groupbys: per-(driver,event) scalar access
    on arrow-backed frames dominated season host prep (~110 ms/event ->
    ~3 ms). Group key order (sorted drivers) and within-group row order
    (stable) are exactly what the groupbys produced, so every dict keeps
    its key order and every reduction sees the same values in the same
    order."""
    p: dict = {}
    drv = np.asarray(ev["Driver"], dtype=object)
    st = np.asarray(ev["session_type"], dtype=object)
    lt = _to_float(ev["LapTime"])
    names, order, starts, ends = _driver_groups(drv)
    lt_sorted = lt[order]
    st_sorted = st[order]

    # nlaps: groupby(Driver, session_type).size() — sorted (d, s) key order
    nlaps: dict = {}
    for d, a, b in zip(names, starts, ends):
        sess = st_sorted[a:b]
        for s in sorted(set(sess)):
            nlaps[(d, s)] = int(np.count_nonzero(sess == s))
    p["nlaps"] = nlaps

    best = np.fmin.reduce(lt) if len(lt) else np.nan
    # overall event gap % to event best (wet-performance / temp-sensitivity
    # consumers; reference features.py:626-685, :730-786). NaN bests or
    # NaN driver values contribute nothing, matching the old pivot's
    # ~isnan masks; a zero best yields ±inf exactly like the pandas div.
    drv_best = _group_min(lt_sorted, starts, ends)
    with np.errstate(divide="ignore", invalid="ignore"):
        gaps = {
            d: float(np.float64(v - best) / np.float64(best) * 100.0)
            for d, v in zip(names, drv_best)
            if not np.isnan(v) and not np.isnan(best)
        }
    if gaps:
        p["ev_gap"] = gaps
    p["ev_best"] = float(best) if not np.isnan(best) else np.nan
    # per-sector gap % to the event's sector best (reference
    # features.py:261-320): (sector_best - v) / sector_best * 100
    for col in ("Sector1Time", "Sector2Time", "Sector3Time"):
        if col in ev.columns:
            sv = _to_float(ev[col])
            sb = np.fmin.reduce(sv) if len(sv) else np.nan
            if np.isnan(sb):
                continue
            sd = _group_min(sv[order], starts, ends)
            with np.errstate(divide="ignore", invalid="ignore"):
                p["sector_gap_" + col] = {
                    d: float(np.float64(sb - v) / np.float64(sb) * 100.0)
                    for d, v in zip(names, sd)
                    if not np.isnan(v)
                }
    if "TrackTemp" in ev.columns:
        tt = _to_float(ev["TrackTemp"])
        tt = tt[~np.isnan(tt)]
        p["temp"] = float(tt.mean()) if tt.size else np.nan
    if "Rainfall" in ev.columns:
        p["wet"] = bool(ev["Rainfall"].any())

    r_mask = st == "R"
    if r_mask.any():
        # within one event (season, circuit) are constant, so the old
        # (Driver, season, circuit) deg grouping reduces to Driver
        r_drv = drv[r_mask]
        r_lt = lt[r_mask]
        r_names, r_order, r_starts, r_ends = _driver_groups(r_drv)
        r_lt_sorted = r_lt[r_order]
        med: dict = {}
        nl: dict = {}
        for d, a, b in zip(r_names, r_starts, r_ends):
            v = r_lt_sorted[a:b]
            v = v[~np.isnan(v)]
            nl[d] = int(v.size)
            med[d] = float(np.median(v)) if v.size else np.nan
        # race pace: % gap of each >=5-lap driver's median to the event's
        # fastest eligible median (reference features.py:396-446)
        elig = {d: m for d, m in med.items() if nl.get(d, 0) >= 5}
        if elig:
            lead = min(elig.values())
            if lead > 0:
                p["rp_delta"] = {
                    d: float((m - lead) / lead * 100.0) for d, m in elig.items()
                }
        # deg slopes: valid laps sorted by (Driver, LapNumber) stable —
        # the old _deg_slopes_all global sort restricted to one event
        keep = ~np.isnan(r_lt)
        k_drv = r_drv[keep]
        k_lt = r_lt[keep]
        if "LapNumber" in ev.columns:
            k_lap = _to_float(ev["LapNumber"])[r_mask][keep]
            k_order = np.lexsort((k_lap, k_drv))
        else:
            k_order = np.argsort(k_drv, kind="stable")
        k_names, _, k_starts, k_ends = _driver_groups(k_drv[k_order])
        k_sorted = k_lt[k_order]
        p["deg"] = {
            d: _session_deg_slope(k_sorted[a:b])
            for d, a, b in zip(k_names, k_starts, k_ends)
        }

    q_mask = st == "Q"
    if q_mask.any():
        q_drv = drv[q_mask]
        q_lt = lt[q_mask]
        q_names, q_order, q_starts, q_ends = _driver_groups(q_drv)
        q_best = _group_min(q_lt[q_order], q_starts, q_ends)
        valid = {
            d: float(v) for d, v in zip(q_names, q_best) if not np.isnan(v)
        }
        if valid:
            sbest = min(valid.values())
            # per-session gap % to session best (gap-to-pole / form score;
            # zero best -> ±inf, exactly the old pivot division)
            with np.errstate(divide="ignore", invalid="ignore"):
                p["q_gaps"] = {
                    d: float(np.float64(v - sbest) / np.float64(sbest) * 100.0)
                    for d, v in valid.items()
                }
            if "Team" in ev.columns:
                # teammate pair deltas within the event (reference
                # features.py:135-185 intent): for same-team pairs with both
                # laps valid and the teammate's > 0, driver i accumulates
                # (v_j - v_i) / v_j * 100. NaN teams pair with nothing
                # (NaN != NaN), covering the my_team.notna() guard.
                # team = first NON-NULL Team per driver (groupby .first()).
                q_team = np.asarray(ev["Team"], dtype=object)[q_mask][q_order]
                team: dict = {}
                for d, a, b in zip(q_names, q_starts, q_ends):
                    team[d] = None
                    for v in q_team[a:b]:
                        if v is not None and not (
                            isinstance(v, float) and np.isnan(v)
                        ):
                            team[d] = v
                            break
                tm_sum: dict = {}
                tm_cnt: dict = {}
                for i, vi in valid.items():
                    ti = team.get(i)
                    if ti is None or (isinstance(ti, float) and np.isnan(ti)):
                        continue
                    for j, vj in valid.items():
                        if j == i or team.get(j) != ti or not vj > 0:
                            continue
                        tm_sum[i] = tm_sum.get(i, 0.0) + (vj - vi) / vj * 100.0
                        tm_cnt[i] = tm_cnt.get(i, 0) + 1
                if tm_cnt:
                    p["tm_sum"], p["tm_cnt"] = tm_sum, tm_cnt

    # per-driver lap-time sum/count over valid laps, original row order
    # within each group (pandas group sums are sequential in row order)
    lap_sum: dict = {}
    lap_n: dict = {}
    valid_mask = ~np.isnan(lt_sorted)
    for d, a, b in zip(names, starts, ends):
        v = lt_sorted[a:b][valid_mask[a:b]]
        if v.size:
            s = 0.0
            for x in v.tolist():
                s += x
            lap_sum[d] = s
            lap_n[d] = int(v.size)
    p["lap_sum"] = lap_sum
    p["lap_n"] = lap_n
    return p


def _session_deg_slope(secs: np.ndarray) -> float:
    """Degradation slope of one driver-race-session's LapNumber-ordered
    valid lap times (features.py:463-486): needs >=10 valid laps, drops laps
    beyond ±10s of the session median, linear fit over the surviving
    original lap indices."""
    if len(secs) < 10:
        return np.nan
    med = np.median(secs)
    keep = np.abs(secs - med) < 10.0
    idx = np.nonzero(keep)[0]
    if len(idx) < 5:
        return np.nan
    return float(np.polyfit(idx.astype(float), secs[keep], 1)[0])


import functools


@functools.lru_cache(maxsize=512)
def _short_name(event: str) -> str:
    """'Bahrain Grand Prix' -> 'Bahrain' (match against config.CIRCUITS)."""
    low = event.lower()
    for name in cfg.TRACK_TYPES:
        if name.lower() in low:
            return name
    return event
