"""The port's serving layer (`monte_carlo_gp_torch.serve`): the twin of
tests/test_serve.py on the port's `F1Predictor(device="cpu")`, where the
race kernel runs its plain PyTorch version, with the stub predictor for the
outage cases; and the port's own contracts: recovery after a sticky device
error needs the in-process device check too, `_integral` rejects strings,
`trip_outage` counts under the lock, the server refuses --device cuda
without a card, and a request under the gbm qualifying model.

The contract is the JAX service's: the same request and seed give
byte-identical probabilities, warm plans are served from the cache, and an
empty-data weekend degrades to the fallback (or 422).
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import HTTPServer
from pathlib import Path

import pytest
import torch

from monte_carlo_gp_torch import serve
from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
from monte_carlo_gp_torch.models.predictor import F1Predictor
from monte_carlo_gp_torch.serve import PredictionService, ServeError

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(2)


def _predictor(cache_dir, **kw):
    return F1Predictor(cache_dir=cache_dir, backend=SyntheticBackend(seed=5, n_events=3),
                       device="cpu", **kw)


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    return PredictionService(_predictor(tmp_path_factory.mktemp("serve_cache")),
                             default_simulations=512)


def test_service_matches_predict_weekend(service, tmp_path):
    status, payload = service.predict(
        {"season": 2024, "race": "Bahrain", "seed": 11, "n_simulations": 512}
    )
    assert status == 200
    # a fresh predictor over the same world through the one-shot API
    direct = _predictor(tmp_path).predict_weekend(2024, "Bahrain", n_simulations=512, seed=11)
    assert payload["win_probabilities"] == direct["win_probabilities"]
    assert payload["full_distributions"] == direct["full_distributions"]
    assert payload["pole_probabilities"] == direct["pole_probabilities"]
    assert payload["server"]["n_simulations"] == 512
    assert payload["server"]["latency_s"] >= 0


def test_plan_cache_and_determinism(service):
    before = dict(service.stats)
    s1, p1 = service.predict({"season": 2024, "race": "Bahrain", "seed": 3})
    s2, p2 = service.predict({"season": 2024, "race": "Bahrain", "seed": 3})
    assert s1 == s2 == 200
    assert p1["full_distributions"] == p2["full_distributions"]
    assert service.stats["plan_cache_hits"] >= before["plan_cache_hits"] + 1
    _, p3 = service.predict({"season": 2024, "race": "Bahrain", "seed": 4})
    assert p3["full_distributions"] != p1["full_distributions"]


def test_penalties_bypass_plan_cache(service):
    misses_before = service.stats["plan_cache_misses"]
    hits_before = service.stats["plan_cache_hits"]
    status, payload = service.predict({
        "season": 2024, "race": "Bahrain", "seed": 3, "grid_penalties": {"VER": 5},
    })
    assert status == 200
    assert service.stats["plan_cache_misses"] == misses_before
    assert service.stats["plan_cache_hits"] == hits_before
    assert abs(sum(payload["win_probabilities"].values()) - 1.0) < 1e-3


def test_request_validation(service):
    for bad in (
        {},
        {"season": "x", "race": "Bahrain"},
        {"season": 2024, "race": "Bahrain", "prediction_point": "fp9"},
        {"season": 2024, "race": "Bahrain", "n_simulations": 0},
        {"season": 2024, "race": "Bahrain", "n_simulations": "many"},
        {"season": 2024, "race": "Bahrain", "actual_grid": {"VER": "P1"}},
        {"season": 2024, "race": "Bahrain", "grid_penalties": [5]},
        {"season": 2024, "race": "Bahrain", "grid_penalties": {"VER": None}},
        {"season": 2024, "race": "Bahrain", "grid_penalties": {"VER": [3]}},
        {"season": 2024, "race": "Bahrain", "seed": 2**64},
        # the Philox key takes seeds in [0, 2**64)
        {"season": 2024, "race": "Bahrain", "seed": -1},
    ):
        status, payload = service.predict(bad)
        assert status == 400, bad
        assert "error" in payload
    assert service.stats["rejected"] >= 11
    assert service.stats["errors"] == 0


def test_fallback_and_strict_modes(tmp_path):
    # an offline predictor over an empty cache has no data for any weekend
    predictor = F1Predictor(cache_dir=tmp_path / "empty", offline=True, device="cpu")
    safe = PredictionService(predictor, default_simulations=64, safe=True)
    status, payload = safe.predict({"season": 2024, "race": "Bahrain"})
    assert status == 200
    assert payload["fallback"] is True
    assert payload["confidence"] == "none"
    assert abs(sum(payload["win_probabilities"].values()) - 1.0) < 1e-6
    assert safe.stats["fallbacks"] == 1

    strict = PredictionService(predictor, default_simulations=64, safe=False)
    status, payload = strict.predict({"season": 2024, "race": "Bahrain"})
    assert status == 422
    assert "No practice data" in payload["error"]


def test_plan_cache_lru_bound(tmp_path):
    svc = PredictionService(_predictor(tmp_path), default_simulations=64, plan_cache_size=2)
    for race in ("Bahrain", "Saudi Arabia", "Australia"):
        status, _ = svc.predict({"season": 2024, "race": race, "seed": 1})
        assert status == 200
    assert len(svc._plans) == 2
    assert svc.stats["plan_cache_evictions"] == 1
    misses = svc.stats["plan_cache_misses"]
    svc.predict({"season": 2024, "race": "Bahrain", "seed": 1})
    assert svc.stats["plan_cache_misses"] == misses + 1
    hits = svc.stats["plan_cache_hits"]
    svc.predict({"season": 2024, "race": "Australia", "seed": 1})
    assert svc.stats["plan_cache_hits"] == hits + 1


def test_plan_cache_ttl_refreshes(tmp_path):
    svc = PredictionService(_predictor(tmp_path), default_simulations=64, plan_ttl_s=0.0)
    _, p1 = svc.predict({"season": 2024, "race": "Bahrain", "seed": 2})
    misses = svc.stats["plan_cache_misses"]
    _, p2 = svc.predict({"season": 2024, "race": "Bahrain", "seed": 2})
    assert svc.stats["plan_cache_misses"] == misses + 1  # expired: prepared again
    assert p1["full_distributions"] == p2["full_distributions"]
    assert len(svc._plans) == 1


def test_invalidate_evicts_matching_plans(service):
    service.plan_for(2024, "Bahrain", "fp2")
    service.plan_for(2024, "Saudi Arabia", "fp2")
    assert service.invalidate(race="Nowhere") == 0
    assert service.invalidate(season=2024, race="Bahrain") == 1
    misses = service.stats["plan_cache_misses"]
    service.predict({"season": 2024, "race": "Bahrain", "seed": 1})
    assert service.stats["plan_cache_misses"] == misses + 1
    assert service.invalidate() >= 1
    assert not service._plans


def test_warmup_prepares_and_compiles(service):
    dt = service.warmup(2024, "Bahrain")
    assert dt >= 0
    hits = service.stats["plan_cache_hits"]
    service.predict({"season": 2024, "race": "Bahrain"})
    assert service.stats["plan_cache_hits"] == hits + 1


def test_penalty_validation_rejects_unknown_names_and_floats(service):
    for bad_value in ("drivethru", 5.5, True, "5"):
        status, payload = service.predict({
            "season": 2024, "race": "Bahrain", "grid_penalties": {"VER": bad_value},
        })
        assert status == 400, bad_value
        assert "error" in payload
    for ok_value in ("engine", 5, 5.0):
        status, _ = service.predict({
            "season": 2024, "race": "Bahrain", "n_simulations": 64,
            "grid_penalties": {"VER": ok_value},
        })
        assert status == 200, ok_value
    status, _ = service.predict({"season": 2024, "race": "Bahrain", "actual_grid": {"VER": 3.7}})
    assert status == 400


def test_integral_rejects_numeric_strings(service):
    """A grid slot must be a JSON number: "5" is rejected in actual_grid as
    it is in grid_penalties."""
    for value in ("5", "5.0", True):
        with pytest.raises(ServeError):
            serve._integral(value, "'actual_grid'")
    assert serve._integral(5.0, "'actual_grid'") == 5
    status, payload = service.predict({"season": 2024, "race": "Bahrain",
                                       "actual_grid": {"VER": "5"}})
    assert status == 400 and "integers" in payload["error"]


def test_public_plan_for_is_thread_safe_entry(service):
    p1 = service.plan_for(2024, "Bahrain", "fp2")
    hits = service.stats["plan_cache_hits"]
    assert service.plan_for(2024, "Bahrain", "fp2") is p1
    assert service.stats["plan_cache_hits"] == hits + 1


def test_request_under_the_gbm_quali_model(tmp_path):
    svc = PredictionService(_predictor(tmp_path / "svc", quali_model="gbm"),
                            default_simulations=256)
    status, payload = svc.predict({"season": 2024, "race": "Bahrain", "seed": 5})
    assert status == 200, payload
    assert abs(sum(payload["pole_probabilities"].values()) - 1.0) < 1e-6
    direct = _predictor(tmp_path / "direct", quali_model="gbm").predict_weekend(
        2024, "Bahrain", n_simulations=256, seed=5)
    assert payload["pole_probabilities"] == direct["pole_probabilities"]
    assert payload["full_distributions"] == direct["full_distributions"]
    elo = _predictor(tmp_path / "elo").predict_weekend(2024, "Bahrain", n_simulations=256, seed=5)
    assert payload["pole_probabilities"] != elo["pole_probabilities"]


# -- outage policy ------------------------------------------------------------


class _FlakyPredictor:
    """Stub predictor whose device stage can be switched into outage mode."""

    def __init__(self, error="race kernel launch failed: CUDA error 700"):
        self.simulate_calls = 0
        self.fail = True
        self.error = error

    def prepare_weekend(self, season, race, prediction_point=None, **kw):
        return ("plan", season, race, prediction_point)

    def simulate_plan(self, plan, n_sims, seed=0):
        self.simulate_calls += 1
        if self.fail:
            raise RuntimeError(self.error)
        return {"VER": {1: 1.0}}

    def assemble_result(self, plan, probs):
        return {
            "pole_probabilities": {"VER": 1.0},
            "win_probabilities": {"VER": 1.0},
            "podium_probabilities": {"VER": 1.0},
            "full_distributions": probs,
            "confidence": "high",
        }


def _outage_service(error=None, **kw):
    kw.setdefault("default_simulations", 64)
    kw.setdefault("outage_cooldown_s", 60.0)
    predictor = _FlakyPredictor() if error is None else _FlakyPredictor(error)
    return PredictionService(predictor, **kw), predictor


def test_outage_trips_cooldown_and_rejects_without_device_touch():
    svc, predictor = _outage_service()
    status, payload = svc.predict({"season": 2024, "race": "Bahrain"})
    assert status == 503
    assert payload["retry_after_s"] > 0
    assert "device outage" in payload["error"]
    assert svc.stats["outages"] == 1
    assert predictor.simulate_calls == 1
    status2, _ = svc.predict({"season": 2024, "race": "Bahrain"})
    assert status2 == 503
    assert predictor.simulate_calls == 1
    assert svc.stats["outage_rejections"] == 2
    health = svc.outage_status()
    assert health["degraded"] is True and health["retry_after_s"] > 0


def test_outage_probe_gates_recovery():
    svc, predictor = _outage_service(outage_cooldown_s=0.01)
    assert svc.predict({"season": 2024, "race": "Bahrain"})[0] == 503
    time.sleep(0.02)
    # cooldown over, but the subprocess probe fails: armed again, no touch
    svc._probe_backend = lambda: False
    assert svc.predict({"season": 2024, "race": "Bahrain"})[0] == 503
    assert predictor.simulate_calls == 1
    time.sleep(0.02)
    svc._probe_backend = lambda: True
    predictor.fail = False
    status, payload = svc.predict({"season": 2024, "race": "Bahrain"})
    assert status == 200
    assert payload["win_probabilities"] == {"VER": 1.0}
    assert svc.outage_status()["degraded"] is False


def test_sticky_error_needs_the_in_process_device_check():
    """After a sticky CUDA error a fresh process passes the probe while this
    process's context stays broken: the service stays degraded until its
    own device answers too."""
    svc, predictor = _outage_service(
        error="CUDA error: an illegal memory access was encountered", outage_cooldown_s=0.01)
    assert svc.predict({"season": 2024, "race": "Bahrain"})[0] == 503
    svc._probe_backend = lambda: True
    checks = []
    svc._device_check = lambda: checks.append(1) or False
    for _ in range(2):
        time.sleep(0.02)
        assert svc.predict({"season": 2024, "race": "Bahrain"})[0] == 503
    assert len(checks) == 2 and predictor.simulate_calls == 1
    assert svc.outage_status()["degraded"] is True
    time.sleep(0.02)
    svc._device_check = lambda: True
    predictor.fail = False
    assert svc.predict({"season": 2024, "race": "Bahrain"})[0] == 200
    assert svc.outage_status()["degraded"] is False
    assert predictor.simulate_calls == 2


def test_device_check_runs_on_the_service_device(tmp_path):
    svc, _ = _outage_service()
    assert svc.device == torch.device("cpu") and svc._device_check() is True
    assert PredictionService(_predictor(tmp_path)).device == torch.device("cpu")


def test_outage_fallback_mode_serves_degraded_200():
    svc, predictor = _outage_service(outage_fallback=True)
    status, payload = svc.predict({"season": 2024, "race": "Bahrain"})
    assert status == 200
    assert payload["degraded"] == "device_outage"
    assert payload["fallback"] is True
    assert abs(sum(payload["win_probabilities"].values()) - 1.0) < 1e-6
    assert payload["server"]["n_simulations"] == 0
    status2, payload2 = svc.predict({"season": 2024, "race": "Monaco"})
    assert status2 == 200 and payload2["degraded"] == "device_outage"
    assert predictor.simulate_calls == 1
    assert svc.stats["fallbacks"] == 2


def test_non_outage_errors_still_500():
    svc, predictor = _outage_service()

    def boom(*a, **k):
        raise ValueError("some unrelated bug")

    predictor.simulate_plan = boom
    status, payload = svc.predict({"season": 2024, "race": "Bahrain"})
    assert status == 500
    assert svc.stats["outages"] == 0
    assert svc.outage_status()["degraded"] is False


def test_out_of_memory_is_not_an_outage():
    svc, predictor = _outage_service()

    def oom(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 64.00 GiB")

    predictor.simulate_plan = oom
    assert svc.predict({"season": 2024, "race": "Bahrain"})[0] == 500
    assert svc.outage_status()["degraded"] is False


def test_trip_outage_counts_under_the_lock():
    """Many threads tripping at once lose no count (a read-modify-write
    outside the lock could)."""
    svc, _ = _outage_service()
    threads, per = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [svc.trip_outage() for _ in range(per)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert svc.stats["outages"] == svc.outage_status()["outages"] == threads * per


# -- HTTP ---------------------------------------------------------------------------


def test_dashboard_html_is_self_contained():
    page = serve.dashboard_html()
    assert page.startswith("<!doctype html>")
    assert "https://" not in page and "http://" not in page
    assert "src=" not in page
    for endpoint in ("/predict", "/healthz", "/stats"):
        assert endpoint in page
    assert "TPU" not in page and "device outage" in page


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, timeout=60):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz_reports_a_degraded_service():
    """/healthz and /predict of a service in an outage, through the handler
    on a server in this process: "degraded", 503 with Retry-After."""
    svc, _ = _outage_service()
    server = HTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, health = _get(f"{base}/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["platform"] == "cpu" and health["device_name"] is None
        req = urllib.request.Request(f"{base}/predict", method="POST",
                                     data=json.dumps({"season": 2024, "race": "Bahrain"}).encode())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 503 and int(err.value.headers["Retry-After"]) >= 1
        status, health = _get(f"{base}/healthz")
        assert health["status"] == "degraded" and health["degraded"] is True
        assert health["outages"] == 1
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def _serve_cmd(*args):
    return [sys.executable, "-m", "monte_carlo_gp_torch.serve", *args]


ENV = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}


def test_serve_http_end_to_end(tmp_path):
    proc = subprocess.Popen(
        _serve_cmd("--synthetic", "--port", "0", "--simulations", "256", "--device", "cpu",
                   "--cache-dir", str(tmp_path / "cache"), "--warm", "2024:Bahrain",
                   # a mistyped warm target must not crash startup in safe mode
                   "--warm", "2024:Nowhere"),
        cwd=tmp_path, env=ENV, text=True, bufsize=1,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    try:
        base, deadline, startup_lines = None, time.time() + 300, []
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                pytest.fail(f"server died: {proc.stderr.read()[-2000:]}")
            startup_lines.append(line)
            if line.startswith("Serving on "):
                base = line.split("Serving on ", 1)[1].strip()
                break
        assert base, "server never printed its readiness line"
        assert any(l.startswith("warm 2024 Nowhere") and "failed:" in l
                   for l in startup_lines), startup_lines

        status, health = _get(f"{base}/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["platform"] == "cpu"

        body = {"season": 2024, "race": "Bahrain", "seed": 7}
        s1, r1 = _post(f"{base}/predict", body)
        assert s1 == 200, r1
        assert abs(sum(r1["win_probabilities"].values()) - 1.0) < 1e-3
        assert r1["server"]["n_simulations"] == 256
        s2, r2 = _post(f"{base}/predict", body)
        assert s2 == 200 and r2["full_distributions"] == r1["full_distributions"]

        status, err = _post(f"{base}/predict", {"race": "Bahrain"})
        assert status == 400 and "season" in err["error"]

        status, stats = _get(f"{base}/stats")
        assert status == 200
        assert stats["ok"] >= 2 and stats["rejected"] >= 1
        assert stats["plan_cache_hits"] >= 2

        status, _ = _get(f"{base}/nope")
        assert status == 404

        status, inv = _post(f"{base}/invalidate", {"race": "Bahrain"})
        assert status == 200 and inv["evicted"] == 1
        s3, r3 = _post(f"{base}/predict", body)
        assert s3 == 200 and r3["full_distributions"] == r1["full_distributions"]
        status, inv = _post(f"{base}/invalidate", {"race": "Nowhere"})
        assert status == 200 and inv["evicted"] == 0
        status, _ = _post(f"{base}/invalidate", {"season": "x"})
        assert status == 400

        import http.client

        host, port = base.split("//", 1)[1].rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        try:
            conn.putrequest("POST", "/predict")
            conn.putheader("Content-Length", str(50_000_000))
            conn.endheaders()
            resp = conn.getresponse()
            assert resp.status == 413, resp.read()
        finally:
            conn.close()

        with urllib.request.urlopen(f"{base}/", timeout=60) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/html")
            page = r.read().decode()
        assert "F1 Prediction Server" in page
        for marker in ("/predict", "/healthz", "/stats", "Pole position", "Race winner", "Podium"):
            assert marker in page
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def test_server_refuses_cuda_without_a_card(tmp_path):
    """--device cuda (the default) without a CUDA device exits non-zero
    before serving; it never serves from the CPU quietly."""
    proc = subprocess.run(_serve_cmd("--synthetic", "--port", "0"), cwd=tmp_path,
                          env={**ENV, "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "Error:" in proc.stderr and "Serving on" not in proc.stdout


@pytest.mark.parametrize("spec", ["2024", "x:Bahrain", "2024:Bahrain:fp9"])
def test_warm_spec_errors_exit_before_serving(spec, capsys):
    with pytest.raises(SystemExit) as exit_:
        serve.main(["--synthetic", "--device", "cpu", "--warm", spec])
    assert exit_.value.code == 2
    assert "--warm" in capsys.readouterr().err


def test_server_refuses_gbm_without_sklearn(monkeypatch, tmp_path):
    for name in [m for m in sys.modules if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(SystemExit) as exit_:
        serve.main(["--synthetic", "--device", "cpu", "--quali-model", "gbm",
                    "--cache-dir", str(tmp_path)])
    assert str(exit_.value.code).startswith("Error:") and "scikit-learn" in str(exit_.value.code)
