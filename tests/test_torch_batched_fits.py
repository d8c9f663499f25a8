"""Fitting several Bayesian qualifying models together, on the CPU: the
batched stage entry (`hmc_kernel.hmc_stages`) and the batched fit
(`bayesian.sample_posteriors`) bitwise each fit alone, over designs of two
values of S (the kernel's parameters per lane), a batch of one as today's
fit, the `fit.batched` counter and the batch's spans; and the Bayesian
walk-forward season, whose fits run together (`prepare_season_plans`),
against the same season race by race (`prepare_weekend`, then the actuals),
plan for plan and field by field, with a race that falls back to the Elo
grid, a season whose races share one archive, a fit the kernel refuses in
the middle of the season, and a failed batch. The kernel's batched launch itself runs only on a card:
tests/test_torch_bayesian_gpu.py holds it to each fit's own launches there.
"""

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.models import bayesian as B
from monte_carlo_gp_torch.ops import hmc_kernel as H
from monte_carlo_gp_torch.utils.profiling import RECORDER
from monte_carlo_gp_torch.validate import backtest as bt
from torch_quali_world import generated_design, world

torch.set_num_threads(2)

# 20 + 20 iterations of 4 leapfrog steps a fit
BUDGET = dict(num_warmup=20, num_samples=20, num_leapfrog=4)
# the walk-forward's fits: BayesianQualiModel's 48 leapfrog steps, 10 + 10
SEASON_BUDGET = dict(num_warmup=10, num_samples=10)


@pytest.fixture(scope="module")
def designs():
    """Four designs of three dims over two values of S: 26 (S = 1, the small
    world), 45 and 55 (S = 2), and 26 again from other rows."""
    return [B.build_quali_design(world()[0]),
            generated_design(600, (8, 20, 12), seed=1),
            generated_design(900, (10, 24, 16), seed=2),
            generated_design(400, (5, 10, 6), seed=3)]


def _equal(a: B.QualiPosterior, b: B.QualiPosterior) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("raw", "accept_rate", "team_effect", "driver_effect", "circuit_effect",
                         "team_mu", "driver_sigma", "sigma"))


def test_the_designs_span_two_values_of_s(designs):
    slots = [H.slots(B.kernel_design(d, "cpu")) for d in designs]
    assert slots == [1, 2, 2, 1]


def test_batched_fits_equal_each_fit_alone(designs):
    batched = B.sample_posteriors(designs, seed=11, device="cpu", **BUDGET)
    alone = [B.sample_posterior(d, seed=11, device="cpu", **BUDGET) for d in designs]
    assert len(batched) == len(designs)
    for got, want, design in zip(batched, alone, designs):
        assert got.design is design
        assert _equal(got, want)


def test_a_batch_of_one_is_the_single_fit(designs):
    before = RECORDER.copy()
    (got,) = B.sample_posteriors(designs[:1], seed=5, device="cpu", **BUDGET)
    added = RECORDER.since(before)
    assert _equal(got, B.sample_posterior(designs[0], seed=5, device="cpu", **BUDGET))
    assert "fit.batched" not in added.counters
    assert added.counts == {"fit.design": 1, "fit.chains": 1, "fit.posterior": 1}


def test_fit_batched_counts_the_fits_and_the_spans_cover_the_batch(designs):
    before = RECORDER.copy()
    B.sample_posteriors(designs[:3], seed=5, device="cpu", **BUDGET)
    added = RECORDER.since(before)
    assert added.counters == {"fit.batched": 3}
    assert added.counts == {"fit.design": 3, "fit.chains": 1, "fit.posterior": 3}


def _stage_inputs(kd, seed, iters=6, chains=3):
    gen = torch.Generator().manual_seed(seed)
    theta = 0.1 * torch.randn(chains, kd.dim, generator=gen)
    theta[:, 1:5] += torch.log(torch.tensor([0.25, 0.15, 0.1, 0.05]))
    return (theta, torch.full((chains,), 0.05), torch.ones(chains, kd.dim),
            torch.randn(iters, chains, kd.dim, generator=gen),
            torch.rand(iters, chains, generator=gen), torch.rand(iters, chains, generator=gen))


@pytest.mark.parametrize("adapt", [True, False])
def test_stages_on_the_cpu_are_each_fits_stage(designs, adapt):
    kds = [B.kernel_design(d, "cpu") for d in designs]
    inputs = [_stage_inputs(kd, seed) for seed, kd in enumerate(kds)]
    launches = H.hmc_stage.launches
    got = H.hmc_stages(kds, *map(list, zip(*inputs)), 3, adapt)
    assert H.hmc_stage.launches == launches  # the plain version launches nothing
    for kd, x, stage in zip(kds, inputs, got):
        want = H.hmc_stage(kd, *x, 3, adapt)
        for field in ("theta", "lp", "eps", "var", "alpha_mean", "lp0", "trace_theta",
                      "trace_lp", "trace_eps", "trace_alpha"):
            a, b = getattr(stage, field), getattr(want, field)
            assert (a is None and b is None) or torch.equal(a, b), field


@pytest.mark.parametrize("case", ["lengths", "empty", "dim"])
def test_stages_refuse_bad_inputs(designs, case):
    kds = [B.kernel_design(d, "cpu") for d in designs[:2]]
    inputs = [list(x) for x in zip(*(_stage_inputs(kd, i) for i, kd in enumerate(kds)))]
    if case == "lengths":
        inputs[3] = inputs[3][:1]
    elif case == "empty":
        kds, inputs = [], [[] for _ in inputs]
    else:
        inputs[0][1] = inputs[0][1][:, :-1].contiguous()
    with pytest.raises(H.HMCKernelError):
        H.hmc_stages(kds, *inputs, 3, True)


# ---------------------------------------------------------------- the walk-forward


def _predictor(cache_dir, n_events=3):
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    p = F1Predictor(cache_dir=cache_dir, backend=SyntheticBackend(seed=5, n_events=n_events),
                    device="cpu", quali_model="bayesian")
    p._bayes_model = B.BayesianQualiModel(device="cpu", **SEASON_BUDGET)
    return p


def _assert_plans_equal(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for field in ("total_laps", "drivers", "quali_probs", "weather", "prediction_point",
                      "grid_is_actual"):
            assert getattr(x, field) == getattr(y, field), field
        for field in x.params.__dataclass_fields__:
            u, v = getattr(x.params, field), getattr(y.params, field)
            assert (torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v), field


def _events(monkeypatch):
    from monte_carlo_gp_torch.models import predictor as P

    events = []
    for module in (bt, P, B):
        monkeypatch.setattr(module, "log_event",
                            lambda name, **kw: events.append((name, kw)), raising=True)
    return events


def _race_by_race(predictor, season, pin_clock=True):
    """The walk-forward as the other models take it: per race
    `prepare_weekend` (its fit inside), then the actuals and their Elo
    updates; a race that raises is skipped."""
    return bt._prepare_race_by_race(predictor, season, False, pin_clock, False)


@pytest.mark.parametrize("season, pin_clock", [(2024, True), (2018, True), (2024, False)])
def test_batched_walk_forward_equals_the_per_race_route(tmp_path, monkeypatch, season,
                                                        pin_clock):
    """2024: every race fits its own archive. 2018: the season's opener has
    no archive (no season before 2018 counts), so it takes the Elo grid at
    its own Elo state. Unpinned: the archive is built once, so the races
    share one fit, as the per-race route's fit cache shares it."""
    events = _events(monkeypatch)
    per_race = _predictor(tmp_path)
    want, want_acts = _race_by_race(per_race, season, pin_clock)
    want_events = list(events)
    events.clear()
    batched = _predictor(tmp_path)
    before = RECORDER.copy()
    got, acts = bt.prepare_season_plans(batched, season, pin_clock=pin_clock, verbose=False)
    added = RECORDER.since(before)
    _assert_plans_equal(got, want)
    assert acts == want_acts and len(got) == 3
    fits = [kw for name, kw in want_events if name == "bayes_quali_fit"]
    assert [kw for name, kw in events if name == "bayes_quali_fit"] == fits
    fallbacks = [kw for name, kw in want_events if name == "alt_quali_fallback"]
    assert [kw for name, kw in events if name == "alt_quali_fallback"] == fallbacks
    assert len(fallbacks) == (1 if season == 2018 else 0)
    assert len(fits) == (1 if not pin_clock else 3 - len(fallbacks))
    assert added.counters.get("fit.batched", 0) == (len(fits) if len(fits) > 1 else 0)
    assert added.counts["fit"] == 1 and added.counts["fit.chains"] == 1
    assert added.counts["weekend.prepare"] == 3
    # the model caches what the per-race route leaves cached
    assert np.array_equal(batched._bayes_model._posterior.raw, per_race._bayes_model._posterior.raw)
    assert not batched._bayes_model._deferred


def test_every_bayesian_walk_forward_batches_its_fits(tmp_path):
    p = _predictor(tmp_path)
    assert p.batches_fits  # on any device: the CPU runs each fit's plain stages in turn
    p._quali_model = "elo"
    assert not p.batches_fits


def test_a_refused_fit_fails_only_its_own_race(tmp_path, monkeypatch):
    """The kernel refuses the middle race's design (a card with one column
    too few for it): that race is skipped before its actuals reach Elo, and
    the races around it are prepared, as race by race."""
    events = _events(monkeypatch)
    real = B.require_capacity

    def refuse_the_second(design, device):
        seen.append(design)
        if len(seen) == 2:
            n_cols = len(design.teams) + len(design.drivers) + len(design.circuits)
            H.require_capacity(n_cols, n_cols - 1, "a card with one column too few")
        real(design, device)

    monkeypatch.setattr(B, "require_capacity", refuse_the_second)
    seen = []
    per_race = _predictor(tmp_path)
    want, want_acts = _race_by_race(per_race, 2024)
    want_events = list(events)
    events.clear()
    seen = []
    batched = _predictor(tmp_path)
    got, acts = bt.prepare_season_plans(batched, 2024, verbose=False)
    _assert_plans_equal(got, want)
    assert acts == want_acts and len(got) == 2
    skips = [kw for name, kw in events if name == "backtest_skip"]
    assert skips == [kw for name, kw in want_events if name == "backtest_skip"]
    races = bt.get_races(batched.data_loader, 2024)
    assert [kw["race"] for kw in skips] == races[1:2] and "at most" in skips[0]["error"]
    assert len([1 for name, _ in events if name == "bayes_quali_fit"]) == 2
    # the refused race's actuals reached neither route's Elo ratings
    got_elo, want_elo = batched.elo_system.state_dict(), per_race.elo_system.state_dict()
    assert got_elo["names"] == want_elo["names"]
    assert np.array_equal(got_elo["ratings"], want_elo["ratings"])


def test_a_failed_batch_skips_every_race_it_held(tmp_path, monkeypatch):
    events = _events(monkeypatch)

    def refuse(*args, **kwargs):
        raise H.HMCKernelError("the batch was refused")

    monkeypatch.setattr(B, "sample_posteriors", refuse)
    p = _predictor(tmp_path)
    races = bt.get_races(p.data_loader, 2018)
    plans, acts = bt.prepare_season_plans(p, 2018, verbose=False)
    skipped = [kw for name, kw in events if name == "backtest_skip"]
    assert len(races) == 3 and [kw["race"] for kw in skipped] == races[1:]
    assert all(kw["error"] == "the batch was refused" for kw in skipped)
    # the opener's Elo grid needed no fit and stays
    assert len(plans) == len(acts) == 1
    assert p._bayes_model._posterior is None and not p._bayes_model._deferred
