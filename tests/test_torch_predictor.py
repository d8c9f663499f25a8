"""The port's single-weekend prediction path (`monte_carlo_gp_torch`
predictor and CLI) against the JAX package's, on the synthetic world:
Bahrain 2024, synthetic seed 2718. The rules of tests/test_predictor.py
(the result contract, the actual-grid and penalty paths, the practice-data
extractors, the sprint chain, the weekend's teams) run on its own world,
synthetic seed 5 with 3 races, each against JAX's output where it has one.

`tests/data/torch_plan_bahrain2024.npz` holds the `SimParams` fields and lap
count that the JAX `prepare_weekend` gives there; `chip_smoke.py` holds the
port's host layer to it on the GPU machine. Regenerate it with
`python tests/test_torch_predictor.py` (the test below fails if it drifts).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PLAN_FIXTURE = ROOT / "tests" / "data" / "torch_plan_bahrain2024.npz"
SEASON, RACE, SYNTHETIC_SEED = 2024, "Bahrain", 2718
# host-derived fields must be exact; grid_probs carries float32 Elo sums
GRID_ATOL = 1e-6

torch.set_num_threads(2)


def jax_plan(cache_dir):
    from monte_carlo_gp_tpu.data.synthetic import SyntheticBackend
    from monte_carlo_gp_tpu.models.predictor import F1Predictor

    predictor = F1Predictor(
        cache_dir=cache_dir, backend=SyntheticBackend(seed=SYNTHETIC_SEED), engine="xla"
    )
    return predictor, predictor.prepare_weekend(SEASON, RACE)


def plan_fields(plan) -> dict[str, np.ndarray]:
    """A plan's SimParams fields plus its lap count and driver list."""
    fields = {
        f.name: np.asarray(getattr(plan.params, f.name))
        for f in dataclasses.fields(plan.params)
    }
    fields["total_laps"] = np.int64(plan.total_laps)
    fields["drivers"] = np.array(plan.drivers)
    return fields


def port_plan_fields(plan) -> dict[str, np.ndarray]:
    fields = {
        f.name: getattr(plan.params, f.name).cpu().numpy()
        for f in dataclasses.fields(plan.params)
    }
    fields["total_laps"] = np.int64(plan.total_laps)
    fields["drivers"] = np.array(plan.drivers)
    return fields


def assert_plans_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in sorted(want):
        if name == "grid_probs":
            np.testing.assert_allclose(got[name], want[name], rtol=0, atol=GRID_ATOL)
        else:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    jpred, jplan = jax_plan(tmp_path_factory.mktemp("jax_cache"))
    tpred = F1Predictor(
        cache_dir=tmp_path_factory.mktemp("torch_cache"),
        backend=SyntheticBackend(seed=SYNTHETIC_SEED),
        device="cpu",
    )
    return jpred, jplan, tpred, tpred.prepare_weekend(SEASON, RACE)


def test_prepare_weekend_equals_jax_field_by_field(plans):
    _, jplan, _, tplan = plans
    assert tplan.drivers == jplan.drivers and len(tplan.drivers) == 20
    assert tplan.total_laps == jplan.total_laps == 57
    assert tplan.weather == jplan.weather
    assert_plans_equal(port_plan_fields(tplan), plan_fields(jplan))


def test_committed_plan_fixture_equals_jax_prepare_weekend(plans):
    _, jplan, _, _ = plans
    with np.load(PLAN_FIXTURE) as f:
        fixture = {k: f[k] for k in f.files}
    assert_plans_equal(fixture, plan_fields(jplan))


def test_predict_weekend_matches_jax_xla_engine(plans):
    """16,384 sims per side on the 57-lap weekend: per-driver total
    variation below 0.07 (Monte Carlo noise floor ~0.04)."""
    jpred, jplan, tpred, tplan = plans
    want = jpred.simulate_plan(jplan, 16_384, seed=1)
    result = tpred.assemble_result(tplan, tpred.simulate_plan(tplan, 16_384, seed=2))
    assert result["n_simulations_effective"] == 16_384
    got = np.array(
        [
            [result["full_distributions"][d].get(p + 1, 0.0) for p in range(20)]
            for d in tplan.drivers
        ]
    )
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    tv = 0.5 * np.abs(got - want).sum(axis=1)
    assert tv.max() < 0.07, tv
    jresult = jpred.assemble_result(jplan, want)
    assert result["pole_probabilities"] == pytest.approx(
        jresult["pole_probabilities"], rel=0, abs=GRID_ATOL
    )
    assert max(result["win_probabilities"], key=result["win_probabilities"].get) == max(
        jresult["win_probabilities"], key=jresult["win_probabilities"].get
    )


def hide_sklearn(monkeypatch):
    """Make scikit-learn unimportable in this process."""
    for name in [m for m in sys.modules if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)


def sklearn_shadow(tmp_path) -> str:
    """A directory whose `sklearn` package raises ImportError, to put first
    on a child process's PYTHONPATH."""
    pkg = tmp_path / "no_sklearn" / "sklearn"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("raise ImportError('No module named sklearn')\n")
    return str(pkg.parent)


def test_alternative_quali_models_construct_and_gbm_needs_sklearn(monkeypatch, tmp_path):
    """Both alternative qualifying models construct on the CPU, the Bayesian
    one on the predictor's device; gbm without scikit-learn fails at
    construction with an error naming it, and the CLI exits with Error:."""
    from monte_carlo_gp_torch.__main__ import run
    from monte_carlo_gp_torch.models.bayesian import BayesianQualiModel
    from monte_carlo_gp_torch.models.ml import GBMQualiModel
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    bayes = F1Predictor(cache_dir=tmp_path, device="cpu", quali_model="bayesian")
    assert isinstance(bayes._bayes_model, BayesianQualiModel)
    assert bayes._bayes_model.device == torch.device("cpu")
    assert isinstance(F1Predictor(cache_dir=tmp_path, device="cpu", quali_model="gbm")._bayes_model,
                      GBMQualiModel)
    assert F1Predictor(cache_dir=tmp_path, device="cpu")._bayes_model is None
    with pytest.raises(ValueError):
        F1Predictor(cache_dir=tmp_path, device="cpu", quali_model="nope")

    hide_sklearn(monkeypatch)
    with pytest.raises(ImportError, match="scikit-learn"):
        F1Predictor(cache_dir=tmp_path, device="cpu", quali_model="gbm")
    with pytest.raises(SystemExit) as exit_:
        run(["--race", RACE, "--season", str(SEASON), "--synthetic", "--device", "cpu",
             "--quali-model", "gbm", "--cache-dir", str(tmp_path)])
    assert str(exit_.value.code).startswith("Error:") and "scikit-learn" in str(exit_.value.code)


def _run_cli(args, cwd, **env):
    return subprocess.run(
        [sys.executable, "-m", "monte_carlo_gp_torch", *args],
        cwd=cwd,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2", **env},
        capture_output=True,
        text=True,
        timeout=300,
    )


@pytest.mark.parametrize("quali_model", ["elo", "gbm"])
def test_cli_runs_the_weekend_on_cpu(quali_model, tmp_path):
    proc = _run_cli(
        ["--race", RACE, "--season", str(SEASON), "--synthetic", "--device", "cpu",
         "--simulations", "2048", "--quali-model", quali_model],
        tmp_path,
    )
    assert proc.returncode == 0, proc.stderr
    for section in (
        "POLE POSITION PROBABILITIES", "RACE WINNER PROBABILITIES",
        "PODIUM PROBABILITIES", "Prediction complete!",
    ):
        assert section in proc.stdout
    assert ("gbm_quali_fit" in proc.stderr) == (quali_model == "gbm")
    assert "alt_quali_fallback" not in proc.stderr


@pytest.mark.parametrize(
    "args, says",
    [(["--device", "cuda"], "Error:"),
     (["--device", "cpu", "--quali-model", "gbm"], "scikit-learn"),
     (["--device", "cuda", "--trace", "out"], "Error:")],
    ids=["cuda_without_gpu", "alt_quali_model", "trace"],
)
def test_cli_refuses_what_it_cannot_run(args, says, tmp_path):
    """No fallback: --device cuda without a CUDA device exits non-zero, with
    or without --trace (no CPU trace stands in for a card's), as does gbm
    where scikit-learn cannot be imported (hidden here)."""
    proc = _run_cli(
        ["--race", RACE, "--season", str(SEASON), "--synthetic", *args],
        tmp_path,
        CUDA_VISIBLE_DEVICES="",
        PYTHONPATH=os.pathsep.join([sklearn_shadow(tmp_path), str(ROOT)]),
    )
    assert proc.returncode != 0
    assert "Error:" in proc.stderr + proc.stdout
    assert says in proc.stderr + proc.stdout
    assert "Prediction complete!" not in proc.stdout
    assert not (tmp_path / "out").exists()


def test_profile_script_refuses_to_run_without_a_gpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "monte_carlo_gp_torch.profile_kernel"],
        cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode != 0
    assert "needs a CUDA device" in proc.stderr
    assert proc.stdout == ""


# -- the rules of tests/test_predictor.py, on its world (synthetic seed 5, 3 races) --


def port_predictor(cache_dir, seed=5, n_events=3, **kw):
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    return F1Predictor(cache_dir=cache_dir, backend=SyntheticBackend(seed=seed, n_events=n_events),
                       device="cpu", **kw)


@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    return port_predictor(tmp_path_factory.mktemp("port_seed5"))


@pytest.fixture(scope="module")
def jax_predictor(tmp_path_factory):
    from monte_carlo_gp_tpu.data.synthetic import SyntheticBackend
    from monte_carlo_gp_tpu.models.predictor import F1Predictor

    return F1Predictor(cache_dir=tmp_path_factory.mktemp("jax_seed5"),
                       backend=SyntheticBackend(seed=5, n_events=3), engine="xla")


@pytest.fixture(scope="module")
def weekend(predictor):
    return predictor.predict_weekend(2024, "Bahrain", n_simulations=2000, seed=11)


def test_result_contract(weekend):
    r = weekend
    for key in (
        "pole_probabilities", "win_probabilities", "podium_probabilities",
        "full_distributions", "weather", "prediction_point", "confidence",
        "grid_is_actual",
    ):
        assert key in r
    assert r["confidence"] == "moderate" and r["prediction_point"] == "fp2"
    assert not r["grid_is_actual"]
    assert len(r["win_probabilities"]) == 20
    assert abs(sum(r["win_probabilities"].values()) - 1.0) < 1e-3
    # pole probabilities are slot-0 marginals of independently normalized
    # position distributions: valid probabilities that need not sum to 1
    assert all(0.0 <= p <= 1.0 for p in r["pole_probabilities"].values())
    for dist in r["full_distributions"].values():
        assert abs(sum(dist.values()) - 1.0) < 1e-3
        assert all(1 <= p <= 20 for p in dist)
    for d in r["win_probabilities"]:
        assert r["podium_probabilities"][d] >= r["win_probabilities"][d] - 1e-9


def test_seed_determinism(predictor, weekend):
    again = predictor.predict_weekend(2024, "Bahrain", n_simulations=2000, seed=11)
    assert again["win_probabilities"] == weekend["win_probabilities"]
    other = predictor.predict_weekend(2024, "Bahrain", n_simulations=2000, seed=12)
    assert other["win_probabilities"] != weekend["win_probabilities"]


def test_simulations_honored(predictor):
    """With few simulations the probabilities are multiples of 1/n: the
    port runs exactly n, with no tile padding."""
    r = predictor.predict_weekend(2024, "Bahrain", n_simulations=128, seed=3)
    assert r["n_simulations_effective"] == 128
    steps = np.array(list(r["win_probabilities"].values())) * 128
    np.testing.assert_allclose(steps, np.round(steps), atol=1e-4)


@pytest.mark.parametrize(
    "penalties", [None, {0: 5, 3: "gearbox", 19: "full_pu"}], ids=["no_penalty", "penalties"]
)
def test_actual_grid_path(penalties, predictor, jax_predictor):
    """The actual grid replaces the model's, then grid penalties shift it,
    as in the JAX predictor, field by field."""
    drivers = predictor.data_loader.backend.drivers
    grid = {d: i + 1 for i, d in enumerate(drivers)}
    penalties = {drivers[i]: p for i, p in (penalties or {}).items()}
    kw = dict(prediction_point="quali", actual_grid=grid, grid_penalties=penalties)
    r = predictor.predict_weekend(2024, "Bahrain", n_simulations=500, seed=1, **kw)
    assert r["grid_is_actual"] and r["confidence"] == "high"
    pole = r["pole_probabilities"]
    assert pole[drivers[1]] == 0.0
    assert pole[drivers[0]] == (0.0 if penalties else 1.0)

    tplan = predictor.prepare_weekend(2024, "Bahrain", **kw)
    jplan = jax_predictor.prepare_weekend(2024, "Bahrain", **kw)
    assert tplan.grid_is_actual and jplan.grid_is_actual
    assert tplan.quali_probs == jplan.quali_probs
    assert_plans_equal(port_plan_fields(tplan), plan_fields(jplan))


def test_model_grid_penalties_equal_jax(predictor, jax_predictor):
    """Penalties on the model-predicted grid (the other branch of the
    JAX predictor's penalty step) give JAX's plan field by field."""
    drivers = predictor.data_loader.backend.drivers
    kw = dict(grid_penalties={drivers[0]: 10, drivers[5]: "gearbox"})
    tplan = predictor.prepare_weekend(2024, "Bahrain", **kw)
    jplan = jax_predictor.prepare_weekend(2024, "Bahrain", **kw)
    assert not tplan.grid_is_actual
    assert tplan.quali_probs[drivers[0]][:10] == [0.0] * 10
    assert tplan.quali_probs == pytest.approx(jplan.quali_probs, rel=0, abs=GRID_ATOL)
    assert_plans_equal(port_plan_fields(tplan), plan_fields(jplan))


def test_wet_weekend(predictor, jax_predictor):
    r = predictor.predict_weekend(2024, "Australia", n_simulations=500, seed=2)
    assert not r["weather"]["rainfall"]
    assert r["weather"] == jax_predictor.prepare_weekend(2024, "Australia").weather


def test_unknown_race_uses_default_circuit(predictor):
    with pytest.raises(ValueError):
        predictor.predict_weekend(2024, "Atlantis", n_simulations=100)


def _bare_predictors():
    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_tpu.models.predictor import F1Predictor as JaxPredictor

    return F1Predictor.__new__(F1Predictor), JaxPredictor.__new__(JaxPredictor)


@pytest.mark.parametrize(
    "penalties, want",
    [({"A": 5}, {"B": 1, "C": 2, "D": 3, "A": 4}),
     ({"B": "gearbox"}, {"A": 1, "C": 2, "D": 3, "B": 4}),
     # B penalized to 3 ties C's 3: the qualifying position wins
     ({"B": 1}, {"A": 1, "B": 2, "C": 3, "D": 4})],
    ids=["places", "gearbox", "tie"],
)
def test_apply_grid_penalties(penalties, want):
    p, jp = _bare_predictors()
    quali = {"A": 1, "B": 2, "C": 3, "D": 4}
    out = p.apply_grid_penalties(quali, penalties)
    assert out == want
    assert out == jp.apply_grid_penalties(quali, penalties)


def test_adjust_for_penalties_shifts_distribution():
    p, jp = _bare_predictors()
    probs = {"A": [0.5, 0.3, 0.2, 0.0], "B": [0.25] * 4}
    out = p._adjust_for_penalties(probs, {"A": 2})
    assert out["A"] == [0.0, 0.0, 0.5, 0.5]  # shifted, the tail accumulates
    assert out["B"] == [0.25] * 4
    assert out == jp._adjust_for_penalties(probs, {"A": 2})
    out = p._adjust_for_penalties(probs, {"A": "full_pu"})  # 20 >= n
    assert out["A"] == [0.0, 0.0, 0.0, 1.0]
    assert out == jp._adjust_for_penalties(probs, {"A": "full_pu"})


def _both(name, frame):
    """A static practice-data extractor of the port and of JAX on `frame`."""
    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_tpu.models.predictor import F1Predictor as JaxPredictor

    got = getattr(F1Predictor, name)(frame.copy())
    assert got == getattr(JaxPredictor, name)(frame.copy())
    return got


def test_extract_race_pace_rules():
    fp = pd.DataFrame(
        {
            "Driver": ["A"] * 5 + ["B"] * 2 + ["C"] * 3,
            "LapTime": [90.0, 85.0, 86.0, 87.0, 95.0, 88.0, 89.0, np.nan, np.nan, np.nan],
            "LapNumber": [1, 2, 3, 4, 5, 1, 2, 1, 2, 3],
            "PitInTime": [np.nan] * 10,
            "PitOutTime": [np.nan] * 10,
        }
    )
    pace = _both("_extract_race_pace", fp)
    # A: middle laps (85, 86, 87) -> median 86; B: < 3 laps -> 25th percentile
    assert pace["A"] == pytest.approx(86.0)
    assert pace["B"] == pytest.approx(np.quantile([88.0, 89.0], 0.25))
    # C: no valid lap -> the field median
    assert pace["C"] == pytest.approx(np.median([86.0, pace["B"]]))


def test_extract_race_pace_filters_pit_laps():
    fp = pd.DataFrame(
        {
            "Driver": ["A"] * 6,
            "LapTime": [90.0, 90.0, 90.0, 90.0, 120.0, 120.0],
            "LapNumber": [1, 2, 3, 4, 5, 6],
            "PitInTime": [np.nan] * 4 + [1.0, np.nan],
            "PitOutTime": [np.nan] * 5 + [1.0],
        }
    )
    assert _both("_extract_race_pace", fp)["A"] == pytest.approx(90.0)


def test_extract_tire_deg_rules():
    rising = [90.0 + 0.06 * i for i in range(10)]
    falling = [90.0 - 0.1 * i for i in range(10)]
    fp = pd.DataFrame(
        {
            "Driver": ["A"] * 10 + ["B"] * 10 + ["C"] * 3,
            "LapTime": rising + falling + [90.0] * 3,
            "LapNumber": list(range(10)) * 2 + [0, 1, 2],
        }
    )
    deg = _both("_extract_tire_deg", fp)
    assert deg["A"] == pytest.approx(0.06, abs=1e-6)
    assert deg["B"] == 0.05  # warming up -> the default
    assert deg["C"] == 0.05  # too few laps


def test_extract_compound_deltas():
    fp = pd.DataFrame(
        {
            "Driver": ["A"] * 12,
            "Compound": ["SOFT"] * 4 + ["MEDIUM"] * 4 + ["HARD"] * 4,
            "LapTime": [89.0, 89.1, 89.2, 98.0]  # 98 is > 107% of 89 -> dropped
            + [90.0, 90.1, 90.2, 90.3]
            + [91.0, 91.1, 91.2, 91.3],
        }
    )
    out = _both("_extract_tire_compound_deltas", fp)
    assert out["SOFT"]["pace_delta"] == pytest.approx(89.1 - 90.15, abs=0.01)
    assert out["MEDIUM"]["pace_delta"] == 0.0
    assert out["HARD"]["pace_delta"] == pytest.approx(91.15 - 90.15, abs=0.01)
    assert out["SOFT"]["optimal_laps"] == 15  # non-pace fields keep their defaults


def test_sprint_weekend_chained_predictions(tmp_path):
    """A sprint weekend chained fp1 -> sprint (grid from sprint qualifying)
    -> race (grid from qualifying), the confidence tightening at each step."""
    p = port_predictor(tmp_path, seed=9, n_events=5)  # includes China (sprint)
    backend = p.data_loader.backend

    early = p.predict_weekend(2024, "China", prediction_point="fp1", n_simulations=512, seed=1)
    assert early["confidence"] == "low"

    sq = backend.load_results(2024, "China Grand Prix", "SQ")
    sq_grid = dict(zip(sq["Abbreviation"], sq["Position"].astype(int)))
    mid = p.predict_weekend(2024, "China", prediction_point="sprint", actual_grid=sq_grid,
                            n_simulations=512, seed=1)
    assert mid["confidence"] == "high" and mid["grid_is_actual"]

    q = backend.load_results(2024, "China Grand Prix", "Q")
    q_grid = dict(zip(q["Abbreviation"], q["Position"].astype(int)))
    final = p.predict_weekend(2024, "China", prediction_point="quali", actual_grid=q_grid,
                              n_simulations=512, seed=1)
    assert final["grid_is_actual"]
    pole_driver = [d for d, g in q_grid.items() if g == 1][0]
    assert final["pole_probabilities"][pole_driver] == 1.0
    for r in (early, mid, final):
        assert abs(sum(r["win_probabilities"].values()) - 1.0) < 1e-3


def test_teams_from_fp_prefers_frame_vocabulary():
    """The weekend's driver -> team map comes from the frame's Team column;
    the static table fills only rows without a Team."""
    from monte_carlo_gp_torch import config as cfg
    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_tpu.models.predictor import F1Predictor as JaxPredictor

    fp = pd.DataFrame(
        {
            "Driver": ["VER", "VER", "HAM", "GHO"],
            "Team": ["Red Bull Racing", "Red Bull Racing", "Scuderia Ferrari", None],
        }
    )
    teams = F1Predictor._teams_from_fp(fp, ["VER", "HAM", "GHO"])
    assert teams["VER"] == "Red Bull Racing"
    assert teams["HAM"] == "Scuderia Ferrari"
    assert teams["GHO"] == cfg.DRIVER_TEAMS.get("GHO")
    assert teams == JaxPredictor._teams_from_fp(fp, ["VER", "HAM", "GHO"])


def test_prepare_weekend_feeds_frame_teams_to_alt_quali(tmp_path):
    """prepare_weekend passes the frame-derived team map into the
    alternative qualifying model."""
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    p = port_predictor(tmp_path, quali_model="gbm")
    captured = {}

    def fake_alt(drivers, race, season, driver_teams=None):
        captured["teams"] = driver_teams
        return None  # the Elo path takes over; only the plumbing is tested

    p._predict_quali_alt = fake_alt
    plan = p.prepare_weekend(2024, "Bahrain")
    fp = p.data_loader.load_session(2024, "Bahrain", "FP2")
    expected = F1Predictor._teams_from_fp(fp, plan.drivers)
    assert captured["teams"] == expected
    assert all(v is not None for v in expected.values())


MUST_IMPORT = (
    "monte_carlo_gp_torch.precompile",
    "monte_carlo_gp_torch.examples.weekend_walkthrough",
    "monte_carlo_gp_torch.backtest",
    "monte_carlo_gp_torch.tune",
    "monte_carlo_gp_torch.validate.backtest",
    "monte_carlo_gp_torch.validate.metrics",
    "monte_carlo_gp_torch.validate.tune",
)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import monte_carlo_gp_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'monte_carlo_gp_tpu')]\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {MUST_IMPORT!r} if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([k for k in sys.modules if k.startswith('monte_carlo_gp_torch')]))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15 + len(MUST_IMPORT)


if __name__ == "__main__":
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        _, plan = jax_plan(tmp)
        PLAN_FIXTURE.parent.mkdir(parents=True, exist_ok=True)
        np.savez(PLAN_FIXTURE, **plan_fields(plan))
    print(f"wrote {PLAN_FIXTURE}")
