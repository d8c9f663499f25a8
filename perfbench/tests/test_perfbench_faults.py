"""The check sees a broken timed path: each run here skips the look for a
card, runs the rest of a run on the CPU at a small size (the kernels'
plain versions), with a fault planted in the program underneath, and
`correct` must come out false. The cells run on one card, so there is no
exchange between cards to leave out. Also the control (the reference in
bfloat16) fails the limits, and a directory with nothing but the benchmark
refuses to run."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.models.predictor import F1Predictor
from monte_carlo_gp_torch.validate import backtest
from perfbench import harness

SMALL = {"n_simulations": 1024, "check_units": 1}


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _correct(workload: str, seed: int, **small) -> bool:
    line, _, _ = harness.run_cell(workload, seed, 0.1, False, device="cpu",
                                  overrides={**SMALL, **small})
    return line["correct"]


def test_a_sound_weekend_is_correct():
    assert _correct("weekend.elo.1m", 11)


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    sound = F1Predictor.simulate_plan

    def swapped(self, plan, n, seed=None, **kw):
        probs = sound(self, plan, n, seed, **kw)
        return probs[[1, 0, *range(2, probs.shape[0])]]

    monkeypatch.setattr(F1Predictor, "simulate_plan", swapped)
    assert not _correct("weekend.elo.1m", 12)


def test_half_the_simulations_left_out(monkeypatch):
    sound = F1Predictor.simulate_plan

    def half(self, plan, n, seed=None, **kw):
        probs = sound(self, plan, n // 2, seed, **kw)  # the mean over the half that ran
        self.last_effective_sims = n
        return probs

    monkeypatch.setattr(F1Predictor, "simulate_plan", half)
    assert not _correct("weekend.elo.1m", 13)


def test_a_walk_forward_that_leaves_its_state_unchanged(monkeypatch):
    monkeypatch.setattr(backtest, "_apply_actual_elo", lambda *a, **k: None)
    assert not _correct("season.elo", 14, n_simulations=128)


def test_a_served_answer_altered_where_it_is_produced(tmp_path: Path, monkeypatch):
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent("""
        from monte_carlo_gp_torch.models.predictor import F1Predictor
        _sound = F1Predictor.simulate_plan
        def _altered(self, plan, n, seed=None, **kw):
            probs = _sound(self, plan, n, seed, **kw)
            probs[0, 0] += 0.01
            return probs
        F1Predictor.simulate_plan = _altered
    """))
    # sitecustomize runs before `-m` puts the checkout on the path
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}:{harness.ROOT}")
    assert not _correct("serve.elo.1m", 15, rate_per_s=2.0)


def test_the_control_fails_the_limits():
    out = harness.calibrate("weekend.elo.1m", 16, 0.1, control=True, device="cpu",
                            overrides=SMALL)
    cell = harness.spec.find_cell(harness.ROOT, "weekend.elo.1m")
    assert all(v <= cell.limits[k] for k, v in out["program"].items())
    assert any(v > cell.limits[k] for k, v in out["control"].items())
    assert np.isfinite(list(out["control"].values())).all()


def test_a_directory_with_only_the_benchmark_refuses(tmp_path: Path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    cmd = json.loads((tmp_path / "BENCHMARK.json").read_text())["command"]
    out = subprocess.run([sys.executable, *cmd[1:], "--workload", "weekend.elo.1m", "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "program" in out.stderr
