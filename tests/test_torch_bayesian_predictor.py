"""The port's Bayesian qualifying model as the predictor uses it, on the
CPU: the fit's bitwise reproducibility per seed, per-chain state, the
archive-token fit cache (the walk-forward leakage contract), and the
predictor's Bayesian path with its Elo fallback; twins of
tests/test_bayesian.py. The comparisons with the JAX package are in
tests/test_torch_bayesian.py.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from monte_carlo_gp_torch.models import bayesian as B
from torch_quali_world import world as _world

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    return _world()


def test_same_seed_bitwise_identical(world):
    design = B.build_quali_design(world[0])
    a, b, c = (B.sample_posterior(design, num_warmup=60, num_samples=30, seed=s, device="cpu")
               for s in (7, 7, 8))
    assert np.array_equal(a.raw, b.raw)
    assert not np.array_equal(a.raw, c.raw)


def test_chains_keep_their_own_state(world):
    """Chain 0's draws are bitwise the same whatever the other chains draw:
    no step size, dual-averaging state or mass is shared across chains."""
    design = B.build_quali_design(world[0])
    logp, grad, _ = B.make_log_posterior(design, "cpu")
    dim = B._param_dim(design)
    init, draws = B.chain_draws(9, 4, dim, 60 + 20)
    other_init, other = B.chain_draws(10, 4, dim, 60 + 20)
    init_b = torch.cat([init[:1], other_init[1:]])
    draws_b = tuple(torch.cat([a[:, :1], b[:, 1:]], dim=1) for a, b in zip(draws, other))
    with torch.inference_mode():
        a, acc_a = B._run_chains(0.1 * init, logp, grad, 60, 20, 12, draws)
        b, acc_b = B._run_chains(0.1 * init_b, logp, grad, 60, 20, 12, draws_b)
    assert not torch.equal(a[:, 1:], b[:, 1:])
    np.testing.assert_array_equal(a[:, 0].numpy(), b[:, 0].numpy())
    assert acc_a[0] == acc_b[0] and not torch.equal(acc_a[1:], acc_b[1:])


# ------------------------------------------------------------ fit cache


def test_model_caches_fit_per_archive_token(world):
    laps = world[0].copy()
    laps.attrs["_mcgp_loader_token"] = object()
    m = B.BayesianQualiModel(num_warmup=40, num_samples=20, device="cpu")
    p1 = m.posterior_for(laps)
    assert m.posterior_for(laps) is p1  # same archive build: cached
    rebuilt = laps.copy()
    rebuilt.attrs["_mcgp_loader_token"] = object()  # walk-forward rebuild
    assert m.posterior_for(rebuilt) is not p1


def test_model_refits_untokened_frames(world):
    laps = world[0].copy()
    laps.attrs.pop("_mcgp_loader_token", None)
    m = B.BayesianQualiModel(num_warmup=40, num_samples=20, device="cpu")
    p1 = m.posterior_for(laps)
    assert m.posterior_for(laps) is not p1  # no token: never trust the cache


# ------------------------------------------------------------ the predictor


def _make_predictor(tmp_path, **kw):
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    return F1Predictor(cache_dir=tmp_path, backend=SyntheticBackend(seed=2718), device="cpu", **kw)


def test_predictor_rejects_unknown_quali_model(tmp_path):
    with pytest.raises(ValueError, match="quali_model"):
        _make_predictor(tmp_path, quali_model="nuts")


def test_predictor_bayesian_path_end_to_end(tmp_path):
    """At a reduced budget (100 + 50), set as the JAX test sets it."""
    p = _make_predictor(tmp_path, quali_model="bayesian")
    assert isinstance(p._bayes_model, B.BayesianQualiModel)
    assert p._bayes_model.device == p.device == torch.device("cpu")
    p._bayes_model = B.BayesianQualiModel(num_warmup=100, num_samples=50, device=p.device)
    plan = p.prepare_weekend(2024, "Bahrain")
    assert p._bayes_model._posterior is not None  # the Bayesian path ran
    arr = np.array([plan.quali_probs[d] for d in plan.drivers])
    np.testing.assert_allclose(arr.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(plan.params.grid_probs.numpy(), arr, atol=1e-6)
    # the same weekend again: cached fit and crc32-seeded noise, identical
    assert p.prepare_weekend(2024, "Bahrain").quali_probs == plan.quali_probs
    plan_elo = _make_predictor(tmp_path, quali_model="elo").prepare_weekend(2024, "Bahrain")
    assert plan.quali_probs != plan_elo.quali_probs


def test_predictor_falls_back_to_elo_on_empty_archive(tmp_path):
    p = _make_predictor(tmp_path, quali_model="bayesian")
    p.feature_engine.laps = pd.DataFrame()  # no archive
    assert p._predict_quali_alt(["VER", "NOR"], "Bahrain", 2024) is None
