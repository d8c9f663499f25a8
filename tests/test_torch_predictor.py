"""The port's single-weekend prediction path (`monte_carlo_gp_torch`
predictor and CLI) against the JAX package's, on the synthetic world:
Bahrain 2024, synthetic seed 2718.

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


def test_alternative_quali_models_are_not_yet_ported(monkeypatch, tmp_path):
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
