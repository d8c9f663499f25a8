"""The port's parameter sweep (`monte_carlo_gp_torch.validate.tune` and
`python -m monte_carlo_gp_torch.tune`), mirroring tests/test_tune.py:
override semantics, grid expansion, and the sweep's contracts — the default
config equals `backtest_model_batched` exactly, identity overrides are
bitwise no-ops, pole_brier is invariant across configs, and the sweep is
deterministic — plus `apply_overrides` against the JAX package's.

Everything here runs the port on the CPU, on a three-race synthetic world.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.config import make_sim_params, sim_params_from_numpy
from monte_carlo_gp_torch.validate.backtest import backtest_model_batched
from monte_carlo_gp_torch.validate.tune import apply_overrides, expand_grid, sweep_backtest

ROOT = Path(__file__).resolve().parents[1]
SEASON = 2024

torch.set_num_threads(2)


def _fields(d=4):
    return dict(
        grid_probs=np.full((d, d), 1.0 / d, np.float32),
        base_pace=np.full(d, 90.0),
        tire_deg=np.full(d, 0.05),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.001),
        team_dnf_rate=np.full(d, 0.002),
    )


def _params(d=4):
    return make_sim_params(**_fields(d))


def _factory(tmp_path, n_events=3):
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    def make():
        return F1Predictor(
            cache_dir=tmp_path, backend=SyntheticBackend(seed=5, n_events=n_events),
            device="cpu",
        )

    return make


# -- unit: apply_overrides / expand_grid -------------------------------------


def test_apply_overrides_scalar_and_scale():
    p = _params()
    q = apply_overrides(p, {"sc_prob": 0.02, "variance_scale": 1.5})
    assert q.sc_prob.dtype == q.variance.dtype == torch.float32
    assert float(q.sc_prob) == np.float32(0.02)
    np.testing.assert_allclose(q.variance.numpy(), 0.15 * 1.5, rtol=1e-6)
    # untouched fields are the same tensors (no copy)
    assert q.base_pace is p.base_pace
    assert q.grid_probs is p.grid_probs


def test_apply_overrides_identity_is_noop():
    p = _params()
    assert apply_overrides(p, {}) is p
    assert apply_overrides(p, {"variance_scale": 1.0}) is p


def test_apply_overrides_unknown_key_raises():
    with pytest.raises(ValueError, match="unknown sweep key"):
        apply_overrides(_params(), {"warp_drive": 2.0})


OVERRIDE_CASES = {
    "scalars": {"sc_prob": 0.05, "drs_delta": 0.45, "pit_loss": 19.5},
    "scales": {"variance_scale": 1.3, "tire_deg_scale": 0.7, "dnf_scale": 3.0,
               "team_dnf_scale": 0.1},
    "identity": {"variance_scale": 1.0, "sc_prob": 0.01},
}


@pytest.mark.parametrize("case", sorted(OVERRIDE_CASES))
def test_apply_overrides_equals_jax(case):
    """On parameters carried across from the JAX package, field by field,
    in float32."""
    from monte_carlo_gp_tpu.config import make_sim_params as jax_make_sim_params
    from monte_carlo_gp_tpu.validate.tune import apply_overrides as jax_apply_overrides

    d = 6
    rng = np.random.default_rng(1)
    fields = dict(_fields(d), variance=0.1 + 0.1 * rng.random(d),
                  tire_deg=0.02 + 0.05 * rng.random(d))
    jp = jax_make_sim_params(**fields)
    tp = sim_params_from_numpy(
        {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    )
    want = jax_apply_overrides(jp, OVERRIDE_CASES[case])
    got = apply_overrides(tp, OVERRIDE_CASES[case])
    for f in dataclasses.fields(jp):
        w = np.asarray(getattr(want, f.name))
        g = getattr(got, f.name).numpy()
        assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_expand_grid_product_and_validation():
    g = expand_grid({"sc_prob": [0.01, 0.02], "variance_scale": [1.0, 1.5]})
    assert len(g) == 4
    assert g[0] == {"sc_prob": 0.01, "variance_scale": 1.0}
    assert g[-1] == {"sc_prob": 0.02, "variance_scale": 1.5}
    with pytest.raises(ValueError, match="unknown sweep key"):
        expand_grid({"nope": [1.0]})


def test_sweep_rejects_empty_grid_and_bad_metric(tmp_path):
    with pytest.raises(ValueError, match="no configurations"):
        sweep_backtest(_factory(tmp_path), [SEASON], {"sc_prob": []})
    with pytest.raises(ValueError, match="unknown metric"):
        sweep_backtest(_factory(tmp_path), [SEASON], {"sc_prob": [0.01]}, metric="vibes")
    with pytest.raises(ValueError, match="pole_brier cannot rank"):
        sweep_backtest(
            _factory(tmp_path), [SEASON], {"sc_prob": [0.01]}, metric="pole_brier"
        )


# -- the sweep itself ---------------------------------------------------------


@pytest.fixture(scope="module")
def sweep_out(tmp_path_factory):
    """One shared sweep run (2x2 grid + default) on the synthetic world."""
    tmp = tmp_path_factory.mktemp("tune")
    return sweep_backtest(
        _factory(tmp),
        [SEASON],
        {"sc_prob": [0.01, 0.05], "variance_scale": [1.0, 8.0]},
        seed=3,
        n_simulations=512,
        verbose=False,
    )


def test_sweep_shape_and_ranking(sweep_out):
    out = sweep_out
    assert out["n_configs"] == 4 and len(out["results"]) == 4
    assert out["best"] is out["results"][0]
    briers = [r["win_brier"] for r in out["results"]]
    assert briers == sorted(briers)
    for rec in out["results"]:
        assert rec["n_races"] == 3
        assert 0.0 <= rec["win_brier"] <= 2.0
        assert set(rec["overrides"]) == {"sc_prob", "variance_scale"}


def test_sweep_pole_brier_invariant_across_configs(sweep_out):
    poles = {r["pole_brier"] for r in sweep_out["results"]}
    poles.add(sweep_out["default"]["pole_brier"])
    assert len(poles) == 1


def test_sweep_default_matches_batched_backtest(tmp_path, sweep_out):
    """The un-overridden config IS backtest_model_batched: same prep, same
    fold_in seed chain -> exactly equal metrics."""
    bat = backtest_model_batched(
        _factory(tmp_path), [SEASON], seed=3, n_simulations=512, verbose=False
    )
    d = sweep_out["default"]
    for key in ("n_races", "pole_brier", "win_brier", "podium_accuracy"):
        assert d[key] == bat[key], key


def test_sweep_identity_config_equals_default(sweep_out):
    identity = next(
        r for r in sweep_out["results"]
        if r["overrides"] == {"sc_prob": 0.01, "variance_scale": 1.0}
    )
    d = sweep_out["default"]
    assert identity["win_brier"] == d["win_brier"]
    assert identity["podium_accuracy"] == d["podium_accuracy"]


def test_sweep_overrides_change_outcomes(sweep_out):
    d = sweep_out["default"]
    scaled = next(
        r for r in sweep_out["results"]
        if r["overrides"] == {"sc_prob": 0.01, "variance_scale": 8.0}
    )
    assert scaled["win_brier"] != d["win_brier"]


def test_sweep_deterministic(tmp_path):
    kwargs = dict(seed=7, n_simulations=256, verbose=False, include_default=False)
    grid = {"drs_delta": [0.1, 0.5]}
    a = sweep_backtest(_factory(tmp_path, 2), [SEASON], grid, **kwargs)
    b = sweep_backtest(_factory(tmp_path, 2), [SEASON], grid, **kwargs)
    assert a["results"] == b["results"]


# -- the CLI ------------------------------------------------------------------------


def test_cli_sweep_on_cpu(monkeypatch, capsys, tmp_path):
    """`run` with the CLI's flags, on the three-race synthetic world."""
    from monte_carlo_gp_torch import tune as cli
    from monte_carlo_gp_torch.data import synthetic

    init = synthetic.SyntheticBackend.__init__
    monkeypatch.setattr(
        synthetic.SyntheticBackend, "__init__",
        lambda self, seed=2718, n_events=None: init(self, seed, n_events or 3),
    )
    out = cli.run(["--synthetic", "--seasons", "2024", "--simulations", "256",
                   "--grid", "sc_prob=0.01,0.05", "--device", "cpu",
                   "--cache-dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert out["n_configs"] == 2 and out["default"]["n_races"] == 3
    assert "Best by win_brier" in printed and "Sweep complete!" in printed
    assert cli.parse_grid(["sc_prob=0.01,0.05", "sc_prob=0.05,0.1"]) == {
        "sc_prob": [0.01, 0.05, 0.1]}
    with pytest.raises(SystemExit):
        cli.parse_grid(["sc_prob"])


@pytest.mark.parametrize("args", [["--device", "cuda", "--grid", "sc_prob=0.01"], ["--device", "cpu"]],
                         ids=["cuda_without_gpu", "no_grid"])
def test_cli_refuses_what_it_cannot_run(args, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "monte_carlo_gp_torch.tune", "--synthetic", *args],
        cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "Sweep complete!" not in proc.stdout
