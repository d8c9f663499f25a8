"""The port's season backtest (`monte_carlo_gp_torch.validate.backtest`,
`validate.metrics` and `python -m monte_carlo_gp_torch.backtest`) against the
JAX package's, on a three-race synthetic world (seed 5), and its own
contracts, mirroring tests/test_validation.py and tests/test_leakage.py.

Everything here runs the port on the CPU, where the race kernels run their
plain PyTorch versions.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.ops import philox
from monte_carlo_gp_torch.ops.engine import run_monte_carlo
from monte_carlo_gp_torch.validate import backtest as tbt
from monte_carlo_gp_torch.validate import metrics as tmetrics
from monte_carlo_gp_tpu.validate import backtest as jbt
from monte_carlo_gp_tpu.validate import metrics as jmetrics

ROOT = Path(__file__).resolve().parents[1]
SEASON, SYNTHETIC_SEED, N_EVENTS = 2024, 5, 3
# host-derived fields must be exact; grid_probs carries float32 Elo sums
GRID_ATOL = 1e-6
# per-race win/podium probabilities of two independent 4,096-sim estimates:
# about 4 sigma of their difference at p = 0.5
PROB_ATOL, COMPARE_SIMS = 0.045, 4096

torch.set_num_threads(2)


def port_factory(cache_dir, n_events=N_EVENTS, **kw):
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    def make():
        return F1Predictor(
            cache_dir=cache_dir, backend=SyntheticBackend(seed=SYNTHETIC_SEED, n_events=n_events),
            device="cpu", **kw,
        )

    return make


def jax_factory(cache_dir, n_events=N_EVENTS):
    from monte_carlo_gp_tpu.data.synthetic import SyntheticBackend
    from monte_carlo_gp_tpu.models.predictor import F1Predictor

    def make():
        return F1Predictor(
            cache_dir=cache_dir, backend=SyntheticBackend(seed=SYNTHETIC_SEED, n_events=n_events),
            engine="xla",
        )

    return make


# -- host preparation, port against JAX ----------------------------------------


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    jpred = jax_factory(tmp_path_factory.mktemp("jax_prep"))()
    tpred = port_factory(tmp_path_factory.mktemp("port_prep"))()
    jplans, jacts = jbt.prepare_season_plans(jpred, SEASON, verbose=False)
    tplans, tacts = tbt.prepare_season_plans(tpred, SEASON, verbose=False)
    return jpred, jplans, jacts, tpred, tplans, tacts


def test_prepare_season_plans_equals_jax(prepared):
    jpred, jplans, jacts, tpred, tplans, tacts = prepared
    assert tbt.get_races(tpred.data_loader, SEASON) == jbt.get_races(jpred.data_loader, SEASON)
    assert len(tplans) == len(jplans) == N_EVENTS
    assert tacts == jacts
    for tplan, jplan in zip(tplans, jplans):
        assert (tplan.drivers, tplan.total_laps, tplan.weather) == (
            jplan.drivers, jplan.total_laps, jplan.weather)
        for f in dataclasses.fields(jplan.params):
            got = getattr(tplan.params, f.name).numpy()
            want = np.asarray(getattr(jplan.params, f.name))
            atol = GRID_ATOL if f.name == "grid_probs" else 0.0
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=f.name)


def test_walk_forward_elo_equals_jax(prepared):
    """Elo after the whole season's walk-forward (historical build plus the
    actual-result updates), to the rtol of tests/test_torch_elo.py."""
    jpred, _, _, tpred, _, _ = prepared
    jstate, tstate = jpred.elo_system.state_dict(), tpred.elo_system.state_dict()
    assert tstate["names"] == jstate["names"]
    np.testing.assert_allclose(tstate["ratings"], jstate["ratings"], rtol=1e-5)


def test_pin_clock_false_gives_other_plans(prepared, tmp_path):
    """The leaky reference mode (the whole season loaded before race 1)
    must change what the plans see."""
    _, _, _, _, pinned, _ = prepared
    leaky, _ = tbt.prepare_season_plans(
        port_factory(tmp_path)(), SEASON, pin_clock=False, verbose=False
    )
    assert len(leaky) == len(pinned)

    def same(a, b):
        return all(
            torch.equal(getattr(a.params, f.name), getattr(b.params, f.name))
            for f in dataclasses.fields(a.params)
        ) and a.quali_probs == b.quali_probs

    assert not all(same(a, b) for a, b in zip(leaky, pinned))


# -- metrics --------------------------------------------------------------------


def _random_predictions(seed, n_races=12, d=20):
    rng = np.random.default_rng(seed)
    drivers = [f"D{i:02d}" for i in range(d)]
    preds, acts = [], []
    for _ in range(n_races):
        win = rng.dirichlet(np.full(d, 0.3))
        podium = np.minimum(1.0, 3 * rng.dirichlet(np.full(d, 0.5)))
        pole = rng.dirichlet(np.full(d, 0.5))
        preds.append({
            "win_probabilities": dict(zip(drivers, win.tolist())),
            "podium_probabilities": dict(zip(drivers, podium.tolist())),
            "pole_probabilities": dict(zip(drivers, pole.tolist())),
        })
        order = list(rng.permutation(drivers))
        acts.append({"winner": order[0], "pole": order[1], "podium": order[:3]})
    preds.append({"win_probabilities": {"D00": 1.5}})  # invalid: skipped
    acts.append({"winner": "D00", "pole": None, "podium": []})
    return preds, acts


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_equal_jax(seed):
    preds, acts = _random_predictions(seed)
    for key, who in (("win_probabilities", "winner"), ("pole_probabilities", "pole")):
        args = ([p.get(key, {}) for p in preds], [a[who] for a in acts])
        assert tmetrics.brier_score(*args) == jmetrics.brier_score(*args)
    assert tmetrics.podium_accuracy(preds, acts) == jmetrics.podium_accuracy(preds, acts)
    assert tmetrics.calibration_analysis(preds, acts) == jmetrics.calibration_analysis(preds, acts)
    probs = [p for pred in preds[:-1] for p in pred["win_probabilities"].values()]
    outcomes = [int(d == a["winner"]) for pred, a in zip(preds, acts)
                for d in pred["win_probabilities"]][: len(probs)]
    for n_bins in (2, 7, 10):
        assert tmetrics._calibration_fallback(outcomes, probs, n_bins) == \
            jmetrics._calibration_fallback(outcomes, probs, n_bins)
    assert tmetrics.RANDOM_BRIER_BASELINE == jmetrics.RANDOM_BRIER_BASELINE


def test_metrics_exact_values():
    """tests/test_validation.py's exact values."""
    preds = [{"A": 0.8, "B": 0.2}]
    assert tmetrics.brier_score(preds, ["A"]) == pytest.approx(0.04)
    assert tmetrics.brier_score(preds, ["B"]) == pytest.approx(0.64)
    assert tmetrics.brier_score(preds, [None]) == 1.0
    assert tmetrics.brier_score([{}], ["A"]) == 1.0
    assert tmetrics.brier_score([{"A": 1.5}], ["A"]) == 1.0
    podium = [{"podium_probabilities": {"A": 0.9, "B": 0.8, "C": 0.7, "D": 0.1}}]
    assert tmetrics.podium_accuracy(podium, [{"podium": ["A", "B", "D"]}]) == pytest.approx(2 / 3)
    assert tmetrics.podium_accuracy(podium, [{"podium": []}]) == 0.0
    assert tmetrics.calibration_analysis([], []) == {"prob_true": [], "prob_pred": []}


# -- the batched backtest, port against JAX ---------------------------------------


def _spy_predictions(monkeypatch, module):
    """Record the per-race predictions `backtest_model_batched` scores."""
    seen = []
    score = module.score_season_plans

    def spy(*args):
        preds, acts = score(*args)
        seen.extend(preds)
        return preds, acts

    monkeypatch.setattr(module, "score_season_plans", spy)
    return seen


def test_batched_backtest_matches_jax_xla_engine(monkeypatch, tmp_path):
    jseen = _spy_predictions(monkeypatch, jbt)
    tseen = _spy_predictions(monkeypatch, tbt)
    common = dict(seed=3, n_simulations=COMPARE_SIMS, verbose=False)
    want = jbt.backtest_model_batched(jax_factory(tmp_path / "jax"), [SEASON], engine="xla", **common)
    got = tbt.backtest_model_batched(port_factory(tmp_path / "port"), [SEASON], **common)
    assert got["n_races"] == want["n_races"] == N_EVENTS
    assert got["pole_brier"] == pytest.approx(want["pole_brier"], rel=0, abs=1e-6)
    assert len(tseen) == len(jseen) == N_EVENTS
    for tpred, jpred in zip(tseen, jseen):
        for key in ("win_probabilities", "podium_probabilities"):
            assert tpred[key].keys() == jpred[key].keys()
            diff = max(abs(tpred[key][d] - jpred[key][d]) for d in jpred[key])
            assert diff < PROB_ATOL, (key, diff)
        assert sum(tpred["win_probabilities"].values()) == pytest.approx(1.0, abs=1e-5)


# -- the port's own contracts (tests/test_validation.py) ------------------------------

SEQ_SIMS = 256


@pytest.fixture(scope="module")
def sequential_run(tmp_path_factory):
    """One uninterrupted sequential backtest with its checkpoint file."""
    tmp = tmp_path_factory.mktemp("seq")
    ckpt = tmp / "full.jsonl"
    result = tbt.backtest_model(
        port_factory(tmp), [SEASON], seed=42, n_simulations=SEQ_SIMS,
        checkpoint_path=ckpt, verbose=False,
    )
    return tmp, result, ckpt.read_text().splitlines()


@pytest.fixture(scope="module")
def batched_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bat")
    return tbt.backtest_model_batched(
        port_factory(tmp), [SEASON], seed=42, n_simulations=SEQ_SIMS, verbose=False
    )


def test_sequential_and_batched_agree_on_pole_brier(sequential_run, batched_run):
    _, seq, lines = sequential_run
    assert len(lines) == N_EVENTS
    assert batched_run["n_races"] == seq["n_races"] == N_EVENTS
    # pole Brier is simulation-free (quali model only) -> identical
    assert batched_run["pole_brier"] == pytest.approx(seq["pole_brier"], abs=1e-9)
    for r in (seq, batched_run):
        assert 0.0 <= r["win_brier"] <= 1.0 and 0.0 <= r["podium_accuracy"] <= 1.0


def test_partial_checkpoint_resume_matches_uninterrupted(sequential_run):
    tmp, full, lines = sequential_run
    ckpt = tmp / "partial.jsonl"
    ckpt.write_text(lines[0] + "\n")
    resumed = tbt.backtest_model(
        port_factory(tmp), [SEASON], seed=42, n_simulations=SEQ_SIMS,
        checkpoint_path=ckpt, verbose=False,
    )
    assert resumed["pole_brier"] == pytest.approx(full["pole_brier"], abs=1e-9)
    assert resumed["win_brier"] == pytest.approx(full["win_brier"], abs=1e-9)
    assert len(ckpt.read_text().splitlines()) == N_EVENTS


def test_checkpoint_resume_tolerates_truncated_trailing_line(sequential_run, caplog):
    import logging

    tmp, full, lines = sequential_run
    ckpt = tmp / "trunc.jsonl"
    # first race intact + second race truncated mid-record
    ckpt.write_text(lines[0] + "\n" + lines[1][: len(lines[1]) // 2] + "\n")
    with caplog.at_level(logging.INFO, logger="mcgp"):
        resumed = tbt.backtest_model(
            port_factory(tmp), [SEASON], seed=42, n_simulations=SEQ_SIMS,
            checkpoint_path=ckpt, verbose=False,
        )
    assert any("checkpoint_skip_line" in r.message for r in caplog.records)
    assert resumed["n_races"] == N_EVENTS
    assert resumed["pole_brier"] == pytest.approx(full["pole_brier"], abs=1e-9)
    assert resumed["win_brier"] == pytest.approx(full["win_brier"], abs=1e-9)


def test_checkpoint_resume_matches_with_rookie_prior(tmp_path):
    """rookie_prior=True resume must reproduce the uninterrupted run: the
    replay re-seeds checkpointed races' rookies before applying their
    actual updates, mirroring prepare_weekend's order."""
    factory = port_factory(tmp_path, rookie_prior=True)
    full_ckpt = tmp_path / "rk_full.jsonl"
    full = tbt.backtest_model(
        factory, [SEASON], seed=42, n_simulations=SEQ_SIMS,
        checkpoint_path=full_ckpt, verbose=False,
    )
    ckpt = tmp_path / "rk_partial.jsonl"
    ckpt.write_text(full_ckpt.read_text().splitlines()[0] + "\n")
    resumed = tbt.backtest_model(
        factory, [SEASON], seed=42, n_simulations=SEQ_SIMS,
        checkpoint_path=ckpt, verbose=False,
    )
    assert resumed["pole_brier"] == full["pole_brier"]
    assert resumed["win_brier"] == full["win_brier"]


def test_reference_compat_elo_noop_differs(batched_run, tmp_path):
    """The corrected walk-forward Elo updates must change later-race
    predictions relative to the reference's silent no-op mode."""
    compat = tbt.backtest_model_batched(
        port_factory(tmp_path), [SEASON], seed=42, n_simulations=SEQ_SIMS,
        reference_compat_elo_noop=True, verbose=False,
    )
    assert compat["n_races"] == batched_run["n_races"] == N_EVENTS
    assert compat["pole_brier"] != batched_run["pole_brier"]


def test_oversize_fields_raise_not_yet_ported(prepared):
    """Fields over 128 drivers no longer raise: a season with one runs race
    by race, the wide race on the lap engine (ops/engine.py), each at its
    `fold_in` seed, the others on the race kernel."""
    _, _, _, tpred, tplans, _ = prepared
    d = 130
    wide = dataclasses.replace(
        tplans[0].params,
        grid_probs=torch.eye(d),
        **{k: torch.zeros(d) for k in ("base_pace", "tire_deg", "variance",
                                       "dnf_rate", "team_dnf_rate")},
        active=torch.ones(d, dtype=torch.bool),
    )
    probs = tbt.simulate_season_plans(tpred, tplans[:2], 0, 64,
                                      params_list=[wide, tplans[1].params])
    d1 = tplans[1].params.n_drivers
    assert [p.shape for p in probs] == [(d, d), (d1, d1)]
    np.testing.assert_allclose(probs[0].sum(axis=1), 1.0, atol=1e-6)
    want = run_monte_carlo(wide, philox.fold_in(0, 0), 64, tplans[0].total_laps)
    np.testing.assert_array_equal(probs[0], want.numpy())


# -- the CLI ------------------------------------------------------------------------------


def _run_cli(args, cwd, **env):
    return subprocess.run(
        [sys.executable, "-m", "monte_carlo_gp_torch.backtest", *args],
        cwd=cwd,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2", **env},
        capture_output=True,
        text=True,
        timeout=600,
    )


def test_cli_runs_the_batched_season_on_cpu(tmp_path):
    proc = _run_cli(
        ["--synthetic", "--seasons", "2024", "--simulations", "512", "--device", "cpu",
         "--batched"],
        tmp_path,
    )
    assert proc.returncode == 0, proc.stderr
    for section in ("Races analyzed: 20", "BRIER SCORES", "PODIUM ACCURACY",
                    "CALIBRATION", "Backtest complete!"):
        assert section in proc.stdout, section


@pytest.mark.parametrize("batched", [False, True], ids=["sequential", "batched"])
def test_cli_runs_the_backtest_with_gbm_on_cpu(batched, tmp_path, monkeypatch, capsys, caplog):
    """`--quali-model gbm` through the CLI's entry point on the three-race
    world, sequential and batched: the gbm grid in every race (one fit per
    walk-forward archive, no Elo fallback), the printed sections."""
    import logging

    from monte_carlo_gp_torch import backtest as backtest_cli
    from monte_carlo_gp_torch.data import synthetic

    world = synthetic.SyntheticBackend
    monkeypatch.setattr(synthetic, "SyntheticBackend",
                        lambda seed: world(seed=seed, n_events=N_EVENTS))
    with caplog.at_level(logging.INFO, logger="mcgp"):
        results = backtest_cli.run(["--synthetic", "--seasons", "2024", "--simulations", "256",
                                    "--device", "cpu", "--quali-model", "gbm",
                                    "--cache-dir", str(tmp_path), *(["--batched"] * batched)])
    records = [r.getMessage() for r in caplog.records]
    out = capsys.readouterr().out
    assert results["n_races"] == N_EVENTS
    for section in (f"Races analyzed: {N_EVENTS}", "BRIER SCORES", "PODIUM ACCURACY",
                    "Backtest complete!"):
        assert section in out, section
    assert sum(r.startswith("gbm_quali_fit") for r in records) == N_EVENTS
    assert not any(r.startswith("alt_quali_fallback") for r in records)


@pytest.mark.parametrize(
    "args, says",
    [(["--batched", "--checkpoint", "f.jsonl", "--device", "cpu"], "not supported with --batched"),
     (["--device", "cuda"], "Error:"),
     (["--device", "cpu", "--quali-model", "gbm"], "scikit-learn")],
    ids=["batched_checkpoint", "cuda_without_gpu", "alt_quali_model"],
)
def test_cli_refuses_what_it_cannot_run(args, says, tmp_path):
    """No fallback: --device cuda without a CUDA device exits non-zero, as
    do gbm where scikit-learn cannot be imported (hidden here) and the
    flags that do not go together."""
    from tests.test_torch_predictor import sklearn_shadow

    proc = _run_cli(["--synthetic", "--seasons", "2024", *args], tmp_path,
                    CUDA_VISIBLE_DEVICES="",
                    PYTHONPATH=os.pathsep.join([sklearn_shadow(tmp_path), str(ROOT)]))
    assert proc.returncode != 0
    assert says in proc.stderr + proc.stdout
    assert "Backtest complete!" not in proc.stdout
    assert not (tmp_path / "f.jsonl").exists()


def test_timed_calls_times_a_module_function_and_restores_it():
    """The season measurements time `prepare_season_plans` inside the
    backtest by wrapping the module's function for the length of a block."""
    from monte_carlo_gp_torch.utils.profiling import Phase, timed_calls

    prepare = tbt.prepare_season_plans
    timers = Phase()
    with timed_calls(tbt, "prepare_season_plans", timers):
        assert tbt.prepare_season_plans is not prepare
        with pytest.raises(AttributeError):  # the wrapped call raises through
            tbt.prepare_season_plans(None, SEASON)
        tbt.prepare_season_plans(SimpleNamespace(data_loader=SimpleNamespace(
            past_events=lambda season: [])), SEASON)
    assert tbt.prepare_season_plans is prepare
    assert timers.counts == {"prepare_season_plans": 2}
    assert timers.totals["prepare_season_plans"] >= 0.0


def test_checkpoint_lines_are_json_records(sequential_run):
    _, _, lines = sequential_run
    recs = [json.loads(line) for line in lines]
    assert [r["season"] for r in recs] == [SEASON] * N_EVENTS
    assert {"pole_probabilities", "win_probabilities", "podium_probabilities"} == set(
        recs[0]["prediction"])


@pytest.mark.slow
def test_alt_quali_models_beat_elo_pole_brier(tmp_path):
    """The walk-forward pole-Brier gate of tests/test_validation.py:409-462
    on the port, on the CPU: the synthetic 2024 season (seed 2718, 20
    races), gbm and Bayesian (300 + 300 HMC iterations) each under 0.02 and
    under half the Elo grid's pole Brier. The Bayesian leg on the card is in
    tests/test_torch_bayesian_gpu.py."""
    from torch_quali_world import GATE_ABS, GATE_REL, alt_quali_pole_briers

    briers = alt_quali_pole_briers(tmp_path, ("elo", "gbm", "bayesian"), "cpu",
                                   bayes_budget=dict(num_warmup=300, num_samples=300))
    print(f"pole Brier on the CPU: {briers}")
    for model in ("gbm", "bayesian"):
        assert briers[model] < GATE_ABS, briers
        assert briers[model] < GATE_REL * briers["elo"], briers
