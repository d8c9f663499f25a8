"""Prediction serving with the PyTorch port: a resident, plan-cached
`F1Predictor` behind a small HTTP front end.

A one-shot CLI run pays the whole pipeline each time (data load, Elo build,
features, the kernel library's load). A resident `PredictionService` keeps
the predictor, the built race kernels and the prepared `WeekendPlan`s warm,
so a repeat request costs the Monte Carlo (one K1 launch on the card) and
the result's assembly.

    python -m monte_carlo_gp_torch.serve --synthetic --port 8000 --warm 2024:Bahrain
    curl -s localhost:8000/healthz
    curl -s -X POST localhost:8000/predict -d '{"season": 2024, "race": "Bahrain", "seed": 7}'

Endpoints:
    GET  /          HTML dashboard (inline CSS/JS, no outside resource)
    GET  /healthz   liveness, the service's device type and the card's name
    GET  /stats     request counters (ok / fallbacks / rejected / errors,
                    plan-cache hits / misses / evictions, outages), plus
                    "spans": the process's span tree under its serve.* spans,
                    {name: {"count", "total_s", "self_s", "children": {...}}}
                    (serve.handle: a POST; its serve.read, serve.predict with
                    serve.plan, the plan-cache lookup or prepare, and the
                    prepare's weekend.* spans beneath, serve.reply), and
                    "frames": the parquet frame cache's {"read", "hit"},
                    "elo_events": the event lists the Elo builds extracted,
                    and "kernels": the race kernels' counters on the card,
                    {"cars", "slots", "packed"} (`ops/race_kernel.py`:
                    cars / slots is the launches' slot fill)
    POST /predict   JSON request -> the predict_weekend result dict plus a
                    "server" block; the same seed gives the same
                    probabilities, bitwise
    POST /invalidate  evict cached weekend plans ({"season", "race",
                    "prediction_point"}, each optional; an empty body
                    clears all) -> {"evicted": N}

Plans are cached per (season, race, prediction_point) in a bounded LRU
(`--plan-cache-size`), re-prepared after `--plan-ttl` seconds when set, so
session data that lands during a weekend is picked up. Requests with grid
penalties or an actual grid prepare their own plan.

Device outages: when a request fails with a device error (a race kernel's
launch error or a CUDA runtime error, `utils/outage.py`), the service
answers 503 with Retry-After for `--outage-cooldown` seconds without
touching the device (with `--outage-fallback`, the safety fallback
predictions, HTTP 200, marked "degraded"). After the cooldown it resumes
only when a tiny op passes both in a fresh subprocess and on its own device
in this process: a sticky CUDA error leaves this process's context broken
while a fresh process passes. `/healthz` says "degraded" meanwhile.

The HTTP layer is single-threaded: one card serialises the Monte Carlo
anyway, and the service's lock guards the device and the plan cache should
a threaded server be put in front. JSON note: full_distributions' integer
position keys serialise as strings.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, HTTPServer

import torch

from monte_carlo_gp_torch.config import PENALTY_TYPES
from monte_carlo_gp_torch.models.safety import (
    InsufficientDataError,
    generate_fallback_predictions,
)
from monte_carlo_gp_torch.utils.logging import get_logger, log_event
from monte_carlo_gp_torch.utils.outage import is_backend_outage, probe_backend_once
from monte_carlo_gp_torch.utils.profiling import RECORDER, span

__all__ = ["PredictionService", "ServeError", "dashboard_html"]

_VALID_POINTS = ("fp1", "fp2", "fp3", "quali", "sprint")


class ServeError(ValueError):
    """A request the service rejects (HTTP 400)."""


def _integral(value, field: str) -> int:
    """A JSON number as an int, rejecting strings, bools and non-integral
    floats (silently truncating 5.7 grid slots would hide a client bug)."""
    if isinstance(value, (bool, str)):
        raise ServeError(f"{field} values must be integers")
    try:
        as_int = int(value)
    except (TypeError, ValueError, OverflowError):
        # OverflowError: json.loads accepts Infinity, and int(inf) raises it
        raise ServeError(f"{field} values must be integers")
    if isinstance(value, float) and value != as_int:
        raise ServeError(f"{field} values must be integral (got {value})")
    return as_int


def dashboard_html() -> str:
    """The dashboard page (GET /): a self-contained HTML client of /predict,
    /healthz and /stats, with no outside resource (the serving host may
    have no network). It shows ranked pole, win and podium probabilities
    and the service's counters."""
    return _DASHBOARD_HTML


_DASHBOARD_HTML = """<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>F1 Prediction Server</title>
<style>
  :root {
    color-scheme: light;
    --surface: #fcfcfb; --panel: #ffffff; --line: #e4e3df;
    --ink: #0b0b0b; --ink-2: #52514e; --bar: #2a78d6;
  }
  @media (prefers-color-scheme: dark) {
    :root {
      color-scheme: dark;
      --surface: #1a1a19; --panel: #232322; --line: #3a3936;
      --ink: #ffffff; --ink-2: #c3c2b7; --bar: #3987e5;
    }
  }
  body { margin: 0; background: var(--surface); color: var(--ink);
         font: 14px/1.45 system-ui, sans-serif; }
  main { max-width: 980px; margin: 0 auto; padding: 20px; }
  h1 { font-size: 18px; margin: 0 0 4px; }
  .sub { color: var(--ink-2); margin: 0 0 16px; }
  .tiles { display: flex; gap: 10px; flex-wrap: wrap; margin: 0 0 16px; }
  .tile { background: var(--panel); border: 1px solid var(--line);
          border-radius: 8px; padding: 8px 14px; min-width: 90px; }
  .tile b { display: block; font-size: 20px; font-variant-numeric: tabular-nums; }
  .tile span { color: var(--ink-2); font-size: 12px; }
  form { display: flex; gap: 8px; flex-wrap: wrap; align-items: end;
         background: var(--panel); border: 1px solid var(--line);
         border-radius: 8px; padding: 12px; margin: 0 0 16px; }
  label { display: flex; flex-direction: column; gap: 2px;
          color: var(--ink-2); font-size: 12px; }
  input, select { font: inherit; color: var(--ink); background: var(--surface);
          border: 1px solid var(--line); border-radius: 6px; padding: 5px 8px; }
  input[type=number] { width: 90px; }
  button { font: inherit; padding: 6px 16px; border-radius: 6px;
           border: 1px solid var(--line); background: var(--bar);
           color: #fff; cursor: pointer; }
  button:disabled { opacity: .5; cursor: wait; }
  .meta, .err { margin: 0 0 12px; color: var(--ink-2); }
  .err { color: #b3261e; }
  .panels { display: grid; gap: 16px;
            grid-template-columns: repeat(auto-fit, minmax(280px, 1fr)); }
  .panel { background: var(--panel); border: 1px solid var(--line);
           border-radius: 8px; padding: 12px; }
  .panel h2 { font-size: 13px; margin: 0 0 10px; color: var(--ink-2);
              text-transform: uppercase; letter-spacing: .04em; }
  .row { display: grid; grid-template-columns: 44px 1fr 52px; gap: 8px;
         align-items: center; margin-bottom: 2px; padding: 2px 0; }
  .row:hover { background: color-mix(in srgb, var(--bar) 8%, transparent); }
  .drv { font-weight: 600; font-variant-numeric: tabular-nums; }
  .track { height: 12px; }
  .bar { height: 12px; background: var(--bar);
         border-radius: 0 4px 4px 0; min-width: 2px; }
  .val { color: var(--ink-2); text-align: right;
         font-variant-numeric: tabular-nums; }
</style></head><body><main>
  <h1>F1 Prediction Server</h1>
  <p class="sub">Monte Carlo race prediction — resident and warm.
     <span id="health"></span></p>
  <div class="tiles" id="tiles"></div>
  <form id="f">
    <label>Season <input type="number" name="season" value="2024" required></label>
    <label>Race <input name="race" value="Bahrain" required></label>
    <label>Point <select name="prediction_point">
      <option>fp1</option><option selected>fp2</option><option>fp3</option>
      <option>quali</option><option>sprint</option></select></label>
    <label>Simulations <input type="number" name="n_simulations" value="10000"></label>
    <label>Seed <input type="number" name="seed" value="0"></label>
    <button id="go">Predict</button>
  </form>
  <p class="meta" id="meta"></p>
  <p class="err" id="err"></p>
  <div class="panels" id="panels"></div>
<script>
const $ = id => document.getElementById(id);
const pct = p => (100 * p).toFixed(1) + "%";

async function refreshStats() {
  try {
    const [h, s] = await Promise.all([
      fetch("/healthz").then(r => r.json()),
      fetch("/stats").then(r => r.json()),
    ]);
    $("health").textContent = "device: " + h.platform +
      (h.device_name ? " (" + h.device_name + ")" : "") +
      (h.degraded ? " — DEGRADED (device outage, retry in " +
                    h.retry_after_s + "s)" : "");
    $("tiles").innerHTML = [
      ["requests", s.requests], ["ok", s.ok], ["fallbacks", s.fallbacks],
      ["rejected", s.rejected], ["errors", s.errors],
      ["plan cache hits", s.plan_cache_hits],
    ].map(([k, v]) => `<div class="tile"><b>${v}</b><span>${k}</span></div>`)
     .join("");
  } catch (e) { $("health").textContent = "stats unavailable"; }
}

function panel(title, probs) {
  const top = Object.entries(probs).sort((a, b) => b[1] - a[1]).slice(0, 10);
  const max = top.length ? top[0][1] : 1;
  const rows = top.map(([d, p]) => `
    <div class="row" title="${d}: ${pct(p)}">
      <span class="drv">${d}</span>
      <div class="track"><div class="bar" style="width:${
        Math.max(100 * p / max, 1).toFixed(1)}%"></div></div>
      <span class="val">${pct(p)}</span>
    </div>`).join("");
  return `<div class="panel"><h2>${title}</h2>${rows}</div>`;
}

$("f").addEventListener("submit", async ev => {
  ev.preventDefault();
  const fd = new FormData(ev.target), body = {};
  for (const [k, v] of fd) body[k] = isNaN(+v) ? v : +v;
  $("go").disabled = true; $("err").textContent = ""; $("meta").textContent = "…";
  try {
    const r = await fetch("/predict", { method: "POST", body: JSON.stringify(body) });
    const j = await r.json();
    if (!r.ok) { $("err").textContent = j.error; $("meta").textContent = ""; }
    else {
      const s = j.server || {};
      $("meta").textContent =
        `${s.season} ${s.race} — ${j.weather && j.weather.rainfall ? "wet" : "dry"}, ` +
        `confidence ${j.confidence}` +
        (j.fallback ? " (FALLBACK: no data)" : "") +
        (s.latency_s != null ? ` — ${(1000 * s.latency_s).toFixed(0)} ms, ` +
         `${s.n_simulations} sims, seed ${s.seed}` : "");
      $("panels").innerHTML =
        panel("Pole position", j.pole_probabilities || {}) +
        panel("Race winner", j.win_probabilities || {}) +
        panel("Podium", j.podium_probabilities || {});
    }
  } catch (e) { $("err").textContent = String(e); $("meta").textContent = ""; }
  $("go").disabled = false;
  refreshStats();
});
refreshStats();
</script></main></body></html>
"""


class PredictionService:
    """Resident predictor + plan cache + request entry point.

    `predict(request)` returns `(status, payload)`: an HTTP status code and
    a JSON-serialisable dict, so the service can sit behind HTTP, a queue
    or a test directly."""

    def __init__(
        self,
        predictor,
        default_simulations: int = 10_000,
        safe: bool = True,
        max_simulations: int = 4_194_304,
        plan_cache_size: int = 64,
        plan_ttl_s: float | None = None,
        outage_cooldown_s: float = 30.0,
        outage_fallback: bool = False,
        outage_probe_timeout_s: float = 20.0,
    ):
        self.predictor = predictor
        self.default_simulations = int(default_simulations)
        self.max_simulations = int(max_simulations)
        self.safe = safe
        if plan_cache_size < 1:
            raise ValueError("plan_cache_size must be >= 1")
        self.plan_cache_size = int(plan_cache_size)
        self.plan_ttl_s = None if plan_ttl_s is None else float(plan_ttl_s)
        # Outage policy: once a request fails with a device error, requests
        # are answered at once (503 with a retry-after, or the safety
        # fallback) for a cooldown, so the single serving thread never
        # queues on a dead device; after it, the device checks of
        # `_check_outage_locked` decide whether to resume.
        self.outage_cooldown_s = float(outage_cooldown_s)
        self.outage_fallback = bool(outage_fallback)
        self.outage_probe_timeout_s = float(outage_probe_timeout_s)
        self._outage_until = 0.0  # monotonic deadline; 0.0 = healthy
        # LRU of (plan, prepared_at_monotonic): bounded, so a client looping
        # over weekends cannot grow memory without limit
        self._plans: OrderedDict[tuple, tuple[object, float]] = OrderedDict()
        self._lock = threading.Lock()
        self.stats = {
            "requests": 0,
            "ok": 0,
            "fallbacks": 0,
            "rejected": 0,
            "errors": 0,
            "plan_cache_hits": 0,
            "plan_cache_misses": 0,
            "plan_cache_evictions": 0,
            "outages": 0,
            "outage_rejections": 0,
        }

    @property
    def device(self) -> torch.device:
        """The device the predictor simulates on (the CPU for a predictor
        that names none)."""
        return torch.device(getattr(self.predictor, "device", "cpu"))

    # -- plan cache -----------------------------------------------------------

    def plan_for(self, season: int, race: str, prediction_point: str):
        """The cached plan of a bare request, under the service's lock."""
        with self._lock:
            return self._plan_for_locked(season, race, prediction_point)

    def _plan_for_locked(self, season: int, race: str, prediction_point: str):
        """The prepared weekend of a bare request, cached per (season, race,
        point) in the bounded LRU (fresh by TTL when `plan_ttl_s` is set).
        The caller holds `self._lock`. Raises InsufficientDataError when the
        data layer is empty. The span `serve.plan`."""
        with span("serve.plan"):
            return self._cached_plan(season, race, prediction_point)

    def _cached_plan(self, season: int, race: str, prediction_point: str):
        key = (season, race, prediction_point)
        entry = self._plans.get(key)
        if entry is not None:
            plan, prepared_at = entry
            if (
                self.plan_ttl_s is None
                or time.monotonic() - prepared_at < self.plan_ttl_s
            ):
                self._plans.move_to_end(key)
                self.stats["plan_cache_hits"] += 1
                return plan
            # expired: prepare afresh (re-reading session files that changed
            # on disk) and replace the entry
            del self._plans[key]
        self.stats["plan_cache_misses"] += 1
        plan = self.predictor.prepare_weekend(season, race, prediction_point=prediction_point)
        self._plans[key] = (plan, time.monotonic())
        while len(self._plans) > self.plan_cache_size:
            self._plans.popitem(last=False)
            self.stats["plan_cache_evictions"] += 1
        return plan

    def invalidate(
        self,
        season: int | None = None,
        race: str | None = None,
        prediction_point: str | None = None,
    ) -> int:
        """Evict cached plans matching the given fields (None matches any);
        no argument clears the cache. Returns the eviction count."""
        with self._lock:
            keys = [
                k
                for k in self._plans
                if (season is None or k[0] == season)
                and (race is None or k[1] == race)
                and (prediction_point is None or k[2] == prediction_point)
            ]
            for k in keys:
                del self._plans[k]
        if keys:
            log_event(
                "serve_invalidate", count=len(keys), season=season, race=race,
                prediction_point=prediction_point,
            )
        return len(keys)

    def warmup(self, season: int, race: str, prediction_point: str = "fp2") -> float:
        """Prepare one weekend (fitting the Bayesian posterior where the
        predictor's qualifying model is that one) and run one Monte Carlo at
        the service's default count, which loads the race-kernel library
        (building it at first use), so the first request is warm. Returns
        the seconds it took."""
        t0 = time.perf_counter()
        # the same lock as predict(): the plan cache and the predictor's
        # per-call state must not interleave with a live request
        with self._lock:
            plan = self._plan_for_locked(season, race, prediction_point)
            self.predictor.simulate_plan(plan, self.default_simulations, seed=0)
        dt = time.perf_counter() - t0
        log_event(
            "serve_warmup", season=season, race=race,
            prediction_point=prediction_point, seconds=round(dt, 3),
        )
        return dt

    # -- request entry point ----------------------------------------------------

    def predict(self, request: dict) -> tuple[int, dict]:
        """Handle one prediction request.

        Request fields: season (int, required), race (str, required),
        prediction_point (default 'fp2'), n_simulations (default the
        service's), seed (default 0, in [0, 2**64)), grid_penalties /
        actual_grid (optional objects; they bypass the plan cache)."""
        self.stats["requests"] += 1
        t0 = time.perf_counter()
        try:
            season, race, point, n_sims, seed, penalties, actual_grid = self._validate(request)
        except ServeError as e:
            self.stats["rejected"] += 1
            return 400, {"error": str(e)}

        try:
            with self._lock:
                blocked, retry_after = self._check_outage_locked()
                if blocked:
                    return self._outage_response(season, race, point, retry_after, t0)
                if penalties or actual_grid:
                    plan = self.predictor.prepare_weekend(
                        season, race,
                        grid_penalties=penalties,
                        prediction_point=point,
                        actual_grid=actual_grid,
                    )
                else:
                    plan = self._plan_for_locked(season, race, point)
                probs = self.predictor.simulate_plan(plan, n_sims, seed=seed)
                result = self.predictor.assemble_result(plan, probs)
            self.stats["ok"] += 1
        except InsufficientDataError as e:
            if not self.safe:
                self.stats["rejected"] += 1
                return 422, {"error": str(e)}
            # the degrade contract of safety.safe_predict
            get_logger().warning("%s, using fallback predictions", e)
            log_event("prediction_fallback", season=season, race=race, reason=str(e))
            result = generate_fallback_predictions(season, race, point)
            self.stats["fallbacks"] += 1
        except Exception as e:  # noqa: BLE001 — a request must never kill the server
            if is_backend_outage(e):
                self.trip_outage()
                get_logger().warning("device outage detected serving %s: %s", race, e)
                log_event(
                    "serve_outage", season=season, race=race,
                    reason=str(e)[:200], cooldown_s=self.outage_cooldown_s,
                )
                return self._outage_response(season, race, point, self.outage_cooldown_s, t0)
            self.stats["errors"] += 1
            get_logger().error("Error predicting %s: %s", race, e)
            log_event("prediction_error", season=season, race=race, reason=str(e))
            return 500, {"error": f"{type(e).__name__}: {e}"}

        dt = time.perf_counter() - t0
        result["server"] = {
            "latency_s": round(dt, 4),
            "n_simulations": n_sims,
            "seed": seed,
            "season": season,
            "race": race,
        }
        log_event(
            "serve_request", season=season, race=race, prediction_point=point,
            n_simulations=n_sims, seed=seed, latency_s=round(dt, 4),
            fallback=bool(result.get("fallback")),
        )
        return 200, result

    # -- outage policy ------------------------------------------------------------

    def _check_outage_locked(self) -> tuple[bool, float]:
        """(blocked, retry_after_s) for the current request; the caller
        holds `self._lock`.

        Inside the cooldown the answer is immediate, with no device touch.
        At the first request after it, the service resumes only when a tiny
        op passes both in a fresh subprocess (`_probe_backend`, bounded, so
        a hung device cannot wedge the serving thread) and on its own device
        in this process (`_device_check`: a sticky CUDA error leaves this
        process's context broken while a fresh process passes). Otherwise
        the cooldown is armed again."""
        if self._outage_until == 0.0:
            return False, 0.0
        now = time.monotonic()
        if now < self._outage_until:
            return True, self._outage_until - now
        probe_ok = self._probe_backend()
        device_ok = probe_ok and self._device_check()
        if device_ok:
            self._outage_until = 0.0
            log_event("serve_outage_recovered")
            return False, 0.0
        self._outage_until = time.monotonic() + self.outage_cooldown_s
        log_event(
            "serve_outage_probe_failed", subprocess_probe=probe_ok,
            in_process=device_ok, cooldown_s=self.outage_cooldown_s,
        )
        return True, self.outage_cooldown_s

    def _probe_backend(self) -> bool:
        """One tiny op on the service's device type in a killable
        subprocess (`utils/outage.probe_backend_once`)."""
        ok, _, _ = probe_backend_once(
            device_type=self.device.type, timeout_s=self.outage_probe_timeout_s
        )
        return ok

    def _device_check(self) -> bool:
        """One tiny op on the service's own device in this process, waited
        for; False when it raises."""
        dev = self.device
        try:
            total = torch.ones(8, device=dev).sum()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return float(total) == 8.0
        except Exception as e:  # noqa: BLE001 — any failure keeps the service degraded
            log_event("serve_device_check_failed", reason=str(e)[:200])
            return False

    def trip_outage(self) -> None:
        """Arm the outage cooldown now (also used when an outage is detected
        outside `predict`, e.g. a failed startup warmup)."""
        with self._lock:
            self._outage_until = time.monotonic() + self.outage_cooldown_s
            self.stats["outages"] += 1

    def _outage_response(
        self, season: int, race: str, point: str, retry_after: float, t0: float
    ) -> tuple[int, dict]:
        """The degraded answer during an outage: 503 with a retry-after by
        default, or (opt-in) the safety-fallback result, for clients that
        prefer a rough prior over an error."""
        if self.outage_fallback:
            result = generate_fallback_predictions(season, race, point)
            result["degraded"] = "device_outage"
            result["server"] = {
                "latency_s": round(time.perf_counter() - t0, 4),
                "n_simulations": 0,
                "seed": None,
                "season": season,
                "race": race,
            }
            self.stats["fallbacks"] += 1
            return 200, result
        self.stats["outage_rejections"] += 1
        return 503, {
            "error": "backend unavailable (device outage); retry later",
            "retry_after_s": round(max(retry_after, 1.0), 1),
        }

    def outage_status(self) -> dict:
        """Health summary for /healthz: the degraded flag and the seconds
        until the next device-checked retry."""
        with self._lock:
            now = time.monotonic()
            degraded = self._outage_until > 0.0
            retry_in = max(0.0, self._outage_until - now) if degraded else 0.0
            outages = self.stats["outages"]
        return {
            "degraded": degraded,
            "retry_after_s": round(retry_in, 1),
            "outages": outages,
        }

    # -- validation ---------------------------------------------------------------

    def _validate(self, request: dict):
        if not isinstance(request, dict):
            raise ServeError("request body must be a JSON object")
        try:
            season = int(request["season"])
            race = str(request["race"])
        except (KeyError, TypeError, ValueError):
            raise ServeError("request requires integer 'season' and string 'race'")
        point = request.get("prediction_point", "fp2")
        if point not in _VALID_POINTS:
            raise ServeError(f"prediction_point must be one of {list(_VALID_POINTS)}")
        try:
            n_sims = int(request.get("n_simulations", self.default_simulations))
            seed = int(request.get("seed", 0))
        except (TypeError, ValueError):
            raise ServeError("'n_simulations' and 'seed' must be integers")
        if not (0 < n_sims <= self.max_simulations):
            raise ServeError(f"n_simulations must be in (0, {self.max_simulations}]")
        if not (0 <= seed < 2**64):
            # the Philox key is the seed's two 32-bit words
            raise ServeError("'seed' must be in [0, 2**64)")
        penalties = request.get("grid_penalties") or None
        actual_grid = request.get("actual_grid") or None
        if penalties is not None:
            if not isinstance(penalties, dict):
                raise ServeError("'grid_penalties' must be an object")
            checked = {}
            for d, v in penalties.items():
                # config.resolve_penalty takes positions (ints) or penalty
                # type names (strings); an unknown name would resolve to 0
                # and a float would truncate, both client errors
                if isinstance(v, str):
                    if v not in PENALTY_TYPES:
                        raise ServeError(
                            f"unknown penalty type {v!r}; valid: {sorted(PENALTY_TYPES)}"
                        )
                    checked[str(d)] = v
                else:
                    checked[str(d)] = _integral(v, "'grid_penalties'")
            penalties = checked
        if actual_grid is not None:
            if not isinstance(actual_grid, dict):
                raise ServeError("'actual_grid' must be an object")
            actual_grid = {
                str(d): _integral(p, "'actual_grid'") for d, p in actual_grid.items()
            }
        return season, race, point, n_sims, seed, penalties, actual_grid


# -- the HTTP front end ---------------------------------------------------------------


def build_predictor(args):
    """The F1Predictor the flags describe; raises RuntimeError for
    --device cuda without a CUDA device and ImportError for gbm without
    scikit-learn."""
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    backend = None
    if args.synthetic:
        from monte_carlo_gp_torch.data.synthetic import SyntheticBackend

        backend = SyntheticBackend(seed=args.synthetic_seed)
    return F1Predictor(
        cache_dir=args.cache_dir,
        offline=args.offline,
        backend=backend,
        external_elo_cache=args.elo_cache,
        use_elo_cache=args.use_elo_cache or args.offline,
        device=args.device,
        rookie_prior=args.rookie_prior,
        quali_model=args.quali_model,
        engine=args.engine,
    )


# The largest accepted /predict body. Real requests are a few hundred bytes
# (season, race and seed, with optional penalty and grid objects over ~20
# drivers); 1 MiB keeps a hostile Content-Length from wedging the single
# serving thread or growing its memory.
MAX_BODY_BYTES = 1 << 20


def make_handler(service: PredictionService):
    device = service.device
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else None

    class Handler(BaseHTTPRequestHandler):
        # a stalled client must not wedge the single serving thread: socket
        # reads time out and end as a handled request error
        timeout = 60

        def log_message(self, fmt, *args):  # noqa: D102 — access logs go through log_event
            pass

        def _reply(self, status: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if status == 503 and "retry_after_s" in payload:
                self.send_header(
                    "Retry-After", str(max(1, int(round(payload["retry_after_s"]))))
                )
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path in ("/", "/dashboard"):
                body = dashboard_html().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/healthz":
                outage = service.outage_status()
                self._reply(200, {
                    "status": "degraded" if outage["degraded"] else "ok",
                    "platform": device.type,
                    "device_name": device_name,
                    "requests": service.stats["requests"],
                    **outage,
                })
            elif self.path == "/stats":
                counters = RECORDER.counters
                self._reply(200, {
                    **service.stats,
                    "spans": RECORDER.tree("serve."),
                    "frames": {"read": counters.get("frames.read", 0),
                               "hit": counters.get("frames.hit", 0)},
                    "elo_events": counters.get("elo.events", 0),
                    "kernels": {name: counters.get(f"race.{name}", 0)
                                for name in ("cars", "slots", "packed")},
                })
            else:
                self._reply(404, {"error": f"no such endpoint: {self.path}"})

        def do_POST(self):  # noqa: N802 (http.server API)
            """One POST, the span `serve.handle` (a request id of its own)
            with `serve.read`, `serve.predict` and `serve.reply` inside."""
            with span("serve.handle", request=True):
                self._post()

        def _reply_span(self, status: int, payload: dict):
            with span("serve.reply"):
                self._reply(status, payload)

        def _post(self):
            if self.path not in ("/predict", "/invalidate"):
                self._reply_span(404, {"error": f"no such endpoint: {self.path}"})
                return
            try:
                with span("serve.read"):
                    length = int(self.headers.get("Content-Length", 0))
                    if length <= MAX_BODY_BYTES:
                        request = json.loads(self.rfile.read(length) or b"{}")
            except ValueError as e:  # a bad Content-Length or body (JSONDecodeError)
                self._reply_span(400, {"error": f"invalid JSON body: {e}"})
                return
            if length > MAX_BODY_BYTES:
                self._reply_span(413, {
                    "error": f"request body too large ({length} > {MAX_BODY_BYTES} bytes)",
                })
                return
            if self.path == "/invalidate":
                if not isinstance(request, dict):
                    self._reply_span(400, {"error": "body must be a JSON object"})
                    return
                try:
                    season = request.get("season")
                    season = None if season is None else int(season)
                    race = request.get("race")
                    race = None if race is None else str(race)
                    point = request.get("prediction_point")
                    point = None if point is None else str(point)
                except (TypeError, ValueError) as e:
                    self._reply_span(400, {"error": f"invalid field: {e}"})
                    return
                self._reply_span(200, {"evicted": service.invalidate(season, race, point)})
                return
            with span("serve.predict"):
                status, payload = service.predict(request)
            self._reply_span(status, payload)

    return Handler


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m monte_carlo_gp_torch.serve", description="F1 Prediction Server"
    )
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument(
        "--port", type=int, default=8000,
        help="TCP port (0 picks a free port; the readiness line names it)",
    )
    parser.add_argument(
        "--simulations", type=int, default=10000,
        help="Default Monte Carlo count per request (requests may override it)",
    )
    parser.add_argument(
        # extend: a repeated --warm adds targets instead of replacing them
        "--warm", type=str, nargs="*", action="extend", default=[],
        metavar="SEASON:RACE[:POINT]",
        help="Weekends to prepare and simulate once before serving "
             "(e.g. 2024:Bahrain 2024:Monaco:quali; the flag may repeat)",
    )
    parser.add_argument(
        "--plan-ttl", type=float, default=None, metavar="SECONDS",
        help="Freshness TTL of cached weekend plans: an older plan is "
             "prepared afresh at the next request (default: cache forever)",
    )
    parser.add_argument(
        "--plan-cache-size", type=int, default=64,
        help="Max cached weekend plans (LRU eviction beyond this)",
    )
    parser.add_argument(
        "--outage-cooldown", type=float, default=30.0, metavar="SECONDS",
        help="After a device outage (a kernel launch error or CUDA error), "
             "answer 503 at once for this long before checking the device again",
    )
    parser.add_argument(
        "--outage-fallback", action="store_true",
        help="During a device outage serve the safety fallback predictions "
             "(HTTP 200, result marked degraded) instead of 503",
    )
    parser.add_argument(
        "--no-safe", action="store_true",
        help="Return 422 on weekends with no usable data instead of "
             "degrading to uniform fallback predictions",
    )
    parser.add_argument("--offline", action="store_true",
                        help="Serve everything from the local cache")
    parser.add_argument("--cache-dir", type=str, default="./cache")
    parser.add_argument("--elo-cache", type=str, default=None)
    parser.add_argument("--use-elo-cache", action="store_true")
    parser.add_argument("--synthetic", action="store_true",
                        help="Deterministic synthetic data backend (demo)")
    parser.add_argument("--synthetic-seed", type=int, default=2718)
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="Where the race Monte Carlo (and the Bayesian fit) runs: the CUDA "
             "kernels (cuda) or their plain PyTorch versions (cpu)",
    )
    parser.add_argument(
        "--engine", choices=["auto", "xla", "pallas"], default="auto",
        help="Simulation backend: the race kernels (pallas) or the lap engine "
             "(xla); auto = pallas",
    )
    parser.add_argument("--rookie-prior", action="store_true")
    parser.add_argument(
        "--quali-model", choices=["elo", "bayesian", "gbm"], default="elo",
        help="Qualifying model: Elo, the Bayesian hierarchical model (HMC on "
             "--device) or gradient boosting (needs scikit-learn)",
    )
    return parser


def _parse_warm(parser: argparse.ArgumentParser, spec: str) -> tuple[int, str, str]:
    parts = spec.split(":")
    if len(parts) not in (2, 3):
        parser.error(f"--warm expects SEASON:RACE[:POINT], got {spec!r}")
    try:
        season = int(parts[0])
    except ValueError:
        parser.error(
            f"--warm expects SEASON:RACE[:POINT] with an integer season, got {spec!r}"
        )
    point = parts[2] if len(parts) == 3 else "fp2"
    if point not in _VALID_POINTS:
        # a mistyped point would warm a cache entry no request can hit
        parser.error(f"--warm point must be one of {_VALID_POINTS}, got {point!r}")
    return season, parts[1], point


def main(argv: list[str] | None = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    warm = [_parse_warm(parser, spec) for spec in args.warm]
    try:
        predictor = build_predictor(args)
    except (RuntimeError, ImportError) as e:
        sys.exit(f"Error: {e}")
    service = PredictionService(
        predictor,
        default_simulations=args.simulations,
        safe=not args.no_safe,
        plan_cache_size=args.plan_cache_size,
        plan_ttl_s=args.plan_ttl,
        outage_cooldown_s=args.outage_cooldown,
        outage_fallback=args.outage_fallback,
    )

    for season, race, point in warm:
        try:
            dt = service.warmup(season, race, point)
        except ValueError as e:
            # A mistyped warm target must not make a serving deployment
            # crash-loop: at runtime the same weekend answers with the safe
            # fallback. Under --no-safe it fails (raw errors were asked for).
            if args.no_safe:
                raise
            print(f"warm {season} {race} ({point}) failed: {e}", flush=True)
            continue
        except Exception as e:  # noqa: BLE001 — a device outage starts the server degraded
            if not is_backend_outage(e):
                raise
            service.trip_outage()
            print(
                f"warm {season} {race} ({point}) hit a device outage "
                f"({str(e)[:120]}); starting degraded",
                flush=True,
            )
            break
        print(f"warm {season} {race} ({point}): {dt:.1f}s", flush=True)

    server = HTTPServer((args.host, args.port), make_handler(service))
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    host, port = server.server_address[:2]
    # the readiness line that tests and orchestrators wait for
    print(f"Serving on http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
