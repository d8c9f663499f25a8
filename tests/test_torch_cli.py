"""CLI smoke tests of the port (the twin of tests/test_cli.py): `python -m
monte_carlo_gp_torch` and the walkthrough as subprocesses on the synthetic
backend, on the CPU (`--device cpu`), the lap engine where the JAX test
asks for `--engine xla`.

The six twins are `slow`, as the JAX tests are. The walkthrough also runs
outside `slow`, held to the JAX package's host layer: the likely
pole-sitter it penalises and each race's actual winner come from the data
and the qualifying model, not the Monte Carlo, so they must equal the JAX
package's on the same synthetic world.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from test_cli import _FAKE_FASTF1

REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
# the JAX stub's facade over the synthetic world, on the port's copy of it
FAKE_FASTF1 = _FAKE_FASTF1.replace("monte_carlo_gp_tpu", "monte_carlo_gp_torch")


def run_cli(args, tmp_path, timeout=420, env=ENV):
    return subprocess.run(
        [sys.executable, "-m", "monte_carlo_gp_torch", *args, "--device", "cpu",
         "--cache-dir", str(tmp_path / "cache")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout,
    )


@pytest.mark.slow
def test_main_cli_synthetic(tmp_path):
    out = run_cli(["--race", "Bahrain", "--season", "2024", "--synthetic",
                   "--simulations", "512", "--seed", "3", "--engine", "xla"], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    for section in ("POLE POSITION PROBABILITIES", "RACE WINNER PROBABILITIES",
                    "PODIUM PROBABILITIES", "Prediction complete!"):
        assert section in out.stdout
    assert any(line.strip().startswith("1.") and "%" in line for line in out.stdout.splitlines())


@pytest.mark.slow
def test_main_cli_build_cache_then_offline(tmp_path):
    built = run_cli(["--build-cache", "--seasons", "2024", "--synthetic"], tmp_path)
    assert built.returncode == 0, built.stderr[-2000:]
    assert "Cached" in built.stdout
    out = run_cli(["--race", "Bahrain", "--season", "2024", "--offline",
                   "--simulations", "256", "--engine", "xla"], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Prediction complete!" in out.stdout


@pytest.mark.slow
def test_main_cli_safe_fallback(tmp_path):
    """--safe degrades an empty-data weekend to uniform fallback predictions
    instead of exiting with an error; without it the weekend exits 1."""
    out = run_cli(["--race", "Bahrain", "--season", "2024", "--offline", "--safe"], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "using fallback predictions" in out.stdout
    assert "Confidence: none" in out.stdout
    assert "POLE POSITION PROBABILITIES" in out.stdout
    out2 = run_cli(["--race", "Bahrain", "--season", "2024", "--offline"], tmp_path)
    assert "Error: No practice data available" in out2.stdout
    assert out2.returncode == 1


@pytest.mark.slow
def test_main_cli_requires_race(tmp_path):
    out = run_cli(["--synthetic"], tmp_path, timeout=120)
    assert out.returncode != 0
    assert "--race is required" in out.stderr


@pytest.mark.slow
def test_main_cli_network_stub_build_cache_then_offline(tmp_path):
    """--build-cache then --offline through the port's real FastF1Backend,
    driven by a file-based fastf1 stub: the offline prediction makes no
    network call and reproduces the one made while the stub was there."""
    stub_dir = tmp_path / "stubsite"
    stub_dir.mkdir()
    (stub_dir / "fastf1.py").write_text(FAKE_FASTF1)
    call_log = tmp_path / "ff1_calls.log"
    env = {**ENV, "PYTHONPATH": os.pathsep.join([str(stub_dir), str(REPO)]),
           "MCGP_REPO": str(REPO), "MCGP_FF1_CALL_LOG": str(call_log), "MCGP_SYN_EVENTS": "3"}

    built = run_cli(["--build-cache", "--seasons", "2023", "2024"], tmp_path, env=env)
    assert built.returncode == 0, built.stderr[-2000:]
    assert "Cached" in built.stdout
    assert call_log.exists() and "get_session" in call_log.read_text()

    predict = ["--race", "Bahrain", "--season", "2024", "--simulations", "256", "--seed", "3",
               "--engine", "xla"]
    online = run_cli(predict, tmp_path, env=env)
    assert online.returncode == 0, online.stderr[-2000:]
    assert "Prediction complete!" in online.stdout
    calls_before_offline = call_log.read_text()
    offline = run_cli(predict + ["--offline"], tmp_path, env=env)
    assert offline.returncode == 0, offline.stderr[-2000:]
    assert "Prediction complete!" in offline.stdout
    assert call_log.read_text() == calls_before_offline
    assert offline.stdout == online.stdout


def run_walkthrough(tmp_path):
    return subprocess.run(
        [sys.executable, "-m", "monte_carlo_gp_torch.examples.weekend_walkthrough",
         "--device", "cpu"],
        cwd=tmp_path,  # the example writes ./cache/example relative to cwd
        env={**ENV, "MCGP_EXAMPLE_SIMS": "512"},
        capture_output=True, text=True, timeout=900,
    )


@pytest.mark.slow
def test_examples_walkthrough_runs(tmp_path):
    out = run_walkthrough(tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FP2 prediction" in out.stdout
    assert "post-quali (actual grid)" in out.stdout
    assert "season batch" in out.stdout
    assert out.stdout.count("predicted") >= 3


def test_walkthrough_agrees_with_the_jax_host_layer(tmp_path):
    """The walkthrough on the CPU prints its four sections, one line per
    race of its six-race season; the driver it penalises is the JAX
    package's likely pole-sitter and each race's actual winner is the JAX
    package's, on the same synthetic world."""
    from monte_carlo_gp_tpu.data.synthetic import SyntheticBackend
    from monte_carlo_gp_tpu.models.predictor import F1Predictor
    from monte_carlo_gp_tpu.validate.backtest import get_actual_results, get_races

    out = run_walkthrough(tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    for section in ("=== FP2 prediction, Bahrain ===", "takes an engine penalty ===",
                    "=== post-quali (actual grid) ===", "=== season batch"):
        assert section in out.stdout
    assert (tmp_path / "cache" / "example").is_dir()

    jax = F1Predictor(cache_dir=tmp_path / "jax", backend=SyntheticBackend(seed=2718, n_events=6))
    plan = jax.prepare_weekend(2024, "Bahrain")
    pole = {d: p[0] for d, p in plan.quali_probs.items()}
    assert f"=== same weekend, {max(pole, key=pole.get)} takes an engine penalty ===" in out.stdout
    races = get_races(jax.data_loader, 2024)
    lines = re.findall(r"^  (.+?)\s+predicted (\w+), actual (\w+)$", out.stdout, re.M)
    assert [r for r, _, _ in lines] == races
    assert [a for _, _, a in lines] == [
        get_actual_results(jax.data_loader, 2024, r)["winner"] for r in races]
