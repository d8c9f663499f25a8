"""The port's utilities (the twin of tests/test_utils.py): phase timers,
`sims_per_second`, structured logging; the `MCGP_COMPILE_CACHE` override of
the build directory (`ops/_build.build_dir`) that the race kernel's library
and the native oracle share; and the prebuild step,
`python -m monte_carlo_gp_torch.precompile`.

`test_bucket_specs_cover_calendar` has no twin: the port has no lap buckets
(the lap count is an argument of the race kernel), so there is no bucket
list to cover the calendar with.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from monte_carlo_gp_torch.ops import _build
from monte_carlo_gp_torch.ops import race_kernel as rk
from monte_carlo_gp_torch.utils.logging import get_logger, log_event
from monte_carlo_gp_torch.utils.profiling import Phase, phase_report, sims_per_second
from monte_carlo_gp_torch.validate import native_oracle as tno
from monte_carlo_gp_tpu.utils.profiling import sims_per_second as jax_sims_per_second

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CHILD_ENV = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}


def test_phase_timers_accumulate():
    timers = Phase()
    with timers("a"):
        pass
    with timers("a"):
        pass
    with timers("b"):
        pass
    assert timers.counts == {"a": 2, "b": 1}
    report = phase_report(timers)
    assert "a" in report and "(2x)" in report


def test_sims_per_second():
    assert sims_per_second(1000, 2.0) == 500.0
    assert sims_per_second(1000, 2.0, n_chips=4) == 125.0
    for args in [(1000, 2.0), (1000, 2.0, 4), (77, 0.3, 0)]:
        assert sims_per_second(*args) == jax_sims_per_second(*args)


def test_log_event_plain_and_json(monkeypatch, caplog):
    get_logger()
    with caplog.at_level(logging.INFO, logger="mcgp"):
        log_event("bench", value=42)
    assert "bench" in caplog.text and "value=42" in caplog.text
    caplog.clear()
    monkeypatch.setenv("MCGP_LOG_JSON", "1")
    with caplog.at_level(logging.INFO, logger="mcgp"):
        log_event("bench", value=42)
    payload = json.loads(caplog.records[-1].message)
    assert payload["event"] == "bench" and payload["value"] == 42


# -- MCGP_COMPILE_CACHE: where built libraries live ----------------------------


@pytest.mark.parametrize("setting", ["path", "unset", "empty"])
def test_build_dir_follows_the_override(setting, monkeypatch, tmp_path):
    """A path puts libraries under <path>/kernels and <path>/native; unset
    or empty, the checkout's build/. It is read at each call, and
    `is_built` looks where `build_cuda_library` would write."""
    if setting == "path":
        monkeypatch.setenv("MCGP_COMPILE_CACHE", str(tmp_path))
        base = tmp_path
    else:
        if setting == "unset":
            monkeypatch.delenv("MCGP_COMPILE_CACHE", raising=False)
        else:
            monkeypatch.setenv("MCGP_COMPILE_CACHE", "")
        base = ROOT / "build"
    lib = _build.library_path("race_kernel", rk._SOURCES)
    assert lib.parent == _build.build_dir("kernels") == base / "kernels"
    assert tno.library_path().parent == _build.build_dir("native") == base / "native"
    if setting == "path":
        assert not rk.is_built()
        lib.parent.mkdir(parents=True)
        lib.write_bytes(b"")
        assert rk.is_built()
    else:
        assert rk.is_built() == lib.exists()


def test_build_dir_zero_is_a_directory_of_the_process_removed_at_exit(tmp_path):
    """MCGP_COMPILE_CACHE=0: no persistent directory. Each process builds
    into a temporary directory of its own, which is gone once it exits."""
    code = (
        "from monte_carlo_gp_torch.ops import _build\n"
        "from monte_carlo_gp_torch.ops import race_kernel as rk\n"
        "from monte_carlo_gp_torch.validate import native_oracle as tno\n"
        "d = _build.build_dir('kernels')\n"
        "assert _build.build_dir('kernels') == d\n"
        "assert tno.library_path().parent == d.parent / 'native'\n"
        "lib = _build.library_path('race_kernel', rk._SOURCES)\n"
        "assert lib.parent == d and not rk.is_built()\n"
        "d.mkdir(parents=True); lib.write_bytes(b'')\n"
        "assert rk.is_built()\n"
        "print(d)\n"
    )
    dirs = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=tmp_path,
            env={**CHILD_ENV, "MCGP_COMPILE_CACHE": "0"},
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stderr
        dirs.append(Path(proc.stdout.strip()))
    assert dirs[0] != dirs[1]
    for d in dirs:
        assert not d.parent.exists(), d
        assert ROOT not in d.parents


def test_two_processes_build_into_one_override_directory(tmp_path):
    """Two processes that build the same library into one shared directory
    at once both succeed, and leave one library and no temporary file: each
    writes its own temporary file and renames it into place."""
    code = (
        "import numpy as np\n"
        "from monte_carlo_gp_torch.config import make_sim_params\n"
        "from monte_carlo_gp_torch.validate.native_oracle import run_native_oracle\n"
        "d = 6\n"
        "params = make_sim_params(grid_probs=np.full((d, d), 1 / d, np.float32),\n"
        "    base_pace=90 + 0.1 * np.arange(d), tire_deg=np.full(d, 0.05),\n"
        "    variance=np.full(d, 0.15), dnf_rate=np.full(d, 0.001),\n"
        "    team_dnf_rate=np.full(d, 0.002))\n"
        "p = run_native_oracle(params, seed=1, n_sims=200, total_laps=5)\n"
        "assert np.allclose(p.sum(1), 1.0)\n"
    )
    env = {**CHILD_ENV, "MCGP_COMPILE_CACHE": str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    assert [f.name for f in (tmp_path / "native").iterdir()] == [tno.library_path().name]
    assert not list(tmp_path.rglob("*.tmp"))


# -- the prebuild step ----------------------------------------------------------


def test_precompile_one_plan_in_process(monkeypatch):
    """compile_one drives the production `simulate_plan` with a dummy plan
    and no real predictor; on a CPU it runs the race kernel's plain
    version (the twin of test_precompile_one_bucket_in_process)."""
    from monte_carlo_gp_torch import precompile
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    seen = []
    real = F1Predictor.simulate_plan
    monkeypatch.setattr(F1Predictor, "simulate_plan",
                        lambda self, plan, n, seed=None, **kw: seen.append(
                            (plan.params.n_drivers, plan.total_laps, n, self.engine))
                        or real(self, plan, n, seed, **kw))
    plain = []
    real_plain = rk.race_counts_plain
    monkeypatch.setattr(rk, "race_counts_plain", lambda *a, **k: plain.append(1) or real_plain(*a, **k))
    dt = precompile.compile_one(12, 64, "pallas", n_drivers=6, device="cpu")
    assert dt > 0
    assert seen == [(6, 12, 64, "pallas")] and plain == [1]


def test_precompile_on_cpu_runs_k1_and_the_season(monkeypatch, capsys):
    """precompile on the CPU: the K1 tier of --drivers once through
    simulate_plan and, with season_races, the season once through
    simulate_season_plans; it returns the count of programs run, builds
    nothing, and prints the JAX step's `precompiled N ...` line."""
    from monte_carlo_gp_torch import precompile
    from monte_carlo_gp_torch.validate import backtest as bt

    monkeypatch.setattr(rk, "build", lambda: pytest.fail("a CPU precompile built the library"))
    seasons = []
    real = bt.simulate_season_plans
    monkeypatch.setattr(bt, "simulate_season_plans",
                        lambda p, plans, *a, **k: seasons.append(len(plans)) or real(p, plans, *a, **k))
    assert precompile.precompile(n_simulations=32, n_drivers=5, device="cpu") == 1
    assert precompile.precompile(n_simulations=32, n_drivers=5, season_races=3, device="cpu") == 2
    assert seasons == [3]
    out = capsys.readouterr().out
    assert "precompiled 1 kernel programs (pallas on cpu, 32 sims, 5 drivers; 0 libraries built)" in out
    assert "precompiled 2 kernel programs" in out


def test_precompile_xla_builds_nothing(monkeypatch, capsys):
    from monte_carlo_gp_torch import precompile

    monkeypatch.setattr(rk, "build", lambda: pytest.fail("--engine xla built the library"))
    monkeypatch.setattr(precompile, "compile_one", lambda *a, **k: pytest.fail("xla ran a plan"))
    assert precompile.precompile(engine="xla", device="cpu") == 0
    assert "nothing to build" in capsys.readouterr().out


@pytest.mark.parametrize(
    "args, rc, says",
    [(["--device", "cpu", "--simulations", "64", "--drivers", "8"], 0,
      "precompiled 1 kernel programs (pallas on cpu, 64 sims, 8 drivers"),
     ([], 1, "Error: device 'cuda' was asked for"),
     (["--engine", "xla"], 1, "Error:")],
    ids=["cpu", "cuda_without_gpu", "xla_cuda_without_gpu"],
)
def test_precompile_cli(args, rc, says, tmp_path):
    """`python -m monte_carlo_gp_torch.precompile`: on the CPU it runs; on
    --device cuda (the default) with no CUDA device it exits non-zero and
    does not fall back to the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "monte_carlo_gp_torch.precompile", *args],
        cwd=tmp_path, env={**CHILD_ENV, "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == rc, proc.stderr
    assert says in proc.stdout + proc.stderr
    assert ("precompiled" in proc.stdout) == (rc == 0)
