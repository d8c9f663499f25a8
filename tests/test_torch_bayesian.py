"""The port's Bayesian hierarchical qualifying model
(`monte_carlo_gp_torch.models.bayesian`) against the JAX package's
(`monte_carlo_gp_tpu.models.bayesian`), on the CPU.

The world is the JAX tests' small generative archive (tests/test_bayesian.py,
seed 0: 5 teams, 10 drivers, 6 circuits, 8 laps each), rebuilt from its
seed in tests/torch_quali_world.py. The deterministic parts (design, log
posterior, gradient, leapfrog, split-R-hat, the predictive grid on given
draws) are held to the JAX functions at the tolerances stated beside each
test. The sampler draws its
own random numbers (a torch.Generator, not threefry), so the two posteriors
are held to each other statistically at the JAX tests' budget (1000 + 1000
iterations, 4 chains, seed 1): per-driver total pace within 0.03
gap-percent, sigma within 10%, pole distributions within total variation
0.05; and each to the JAX tests' own gates (R-hat < 1.15, acceptance in
0.6-0.99, effect recovery correlation > 0.95).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from monte_carlo_gp_torch.models import bayesian as B
from monte_carlo_gp_torch.ops import hmc_kernel
from monte_carlo_gp_tpu.models import bayesian as JB
from torch_quali_world import DRIVERS, TEAM_OF, total_pace
from torch_quali_world import world as _world

torch.set_num_threads(2)

# float32 sums of a few hundred rows in another order
LOGP_RTOL = 1e-5
GRAD_RTOL = GRAD_ATOL = 1e-4
# leapfrog: the gradient's last-bit differences carried through 48 steps
LEAPFROG_RTOL, LEAPFROG_ATOL = 1e-4, 1e-3
# the two samplers' statistical agreement at 1000 + 1000 iterations
TOTAL_ATOL, SIGMA_RTOL, POLE_TV = 0.03, 0.10, 0.05


@pytest.fixture(scope="module")
def world():
    return _world()


@pytest.fixture(scope="module")
def posteriors(world):
    """(the port's, the JAX package's) posterior at the JAX test's budget."""
    laps, _ = world
    port = B.sample_posterior(B.build_quali_design(laps), num_warmup=1000, num_samples=1000,
                              seed=1, device="cpu")
    ref = JB.sample_posterior(JB.build_quali_design(laps), num_warmup=1000, num_samples=1000,
                              seed=1)
    return port, ref


@pytest.fixture(scope="module")
def posterior(posteriors):
    return posteriors[0]


def _thetas(design, n, seed, spread):
    rng = np.random.default_rng(seed)
    theta = (spread * rng.standard_normal((n, B._param_dim(design)))).astype(np.float32)
    theta[:, 1:B._N_SCALAR] += np.log(np.array(B._PRIOR_SCALES, np.float32) / 2)
    return theta


# ------------------------------------------------------------ against the JAX functions


def test_world_is_the_jax_tests_world(world):
    from tests.test_bayesian import _world as jax_world

    laps, truth = world
    want, want_truth = jax_world()
    pd.testing.assert_frame_equal(laps, want)
    for k in truth:
        np.testing.assert_array_equal(truth[k], want_truth[k])


@pytest.mark.parametrize("session_type", ["Q", None])
def test_design_equals_jax_field_by_field(world, session_type):
    laps, _ = world
    laps = pd.concat([laps, pd.DataFrame(dict(
        Driver=["Z", "D0"], Team=["T0", "T0"], circuit=["C0", "C0"],
        LapTime=[np.nan, 70.0], session_type=["Q", "R"]))], ignore_index=True)
    got, want = B.build_quali_design(laps, session_type), JB.build_quali_design(laps, session_type)
    for f in ("y", "team_idx", "driver_idx", "circuit_idx"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert (got.teams, got.drivers, got.circuits) == (want.teams, want.drivers, want.circuits)
    assert B._param_dim(got) == JB._param_dim(want)


def test_design_gap_is_percent_to_circuit_fastest():
    laps = pd.DataFrame(dict(Driver=["A", "B", "A", "B"], Team=["X", "Y", "X", "Y"],
                             circuit=["c1", "c1", "c2", "c2"], LapTime=[80.0, 81.0, 90.0, 91.8]))
    d = B.build_quali_design(laps, session_type=None)
    np.testing.assert_allclose(d.y, [0.0, 1.25, 0.0, 2.0], rtol=1e-6)
    assert d.teams == ("X", "Y") and d.drivers == ("A", "B")
    assert d.circuits == ("c1", "c2")
    assert d.team_idx.tolist() == [0, 1, 0, 1]


def test_design_drops_nan_and_filters_session(world):
    laps, _ = world
    spiked = pd.concat([laps, pd.DataFrame(dict(
        Driver=["Z", "D0"], Team=["T0", "T0"], circuit=["C0", "C0"],
        LapTime=[np.nan, 70.0], session_type=["Q", "R"]))], ignore_index=True)
    d = B.build_quali_design(spiked)
    assert d.n_rows == len(laps)  # the NaN row and the R row are both out
    assert "Z" not in d.drivers


def test_design_raises_on_empty():
    with pytest.raises(ValueError, match="No valid lap times"):
        B.build_quali_design(pd.DataFrame())
    with pytest.raises(ValueError, match="No valid lap times"):
        B.build_quali_design(pd.DataFrame(dict(Driver=["A"], Team=["X"], circuit=["c"],
                                               LapTime=[np.nan])))


def test_design_refuses_race_only_archive():
    """An archive with a session_type column but no 'Q' row raises (the
    predictor turns it into the Elo path), in both models; session_type=None
    trains on every row."""
    from monte_carlo_gp_torch.models import ml

    race_only = pd.DataFrame(dict(Driver=["A", "B"], Team=["X", "Y"], circuit=["c1", "c1"],
                                  LapTime=[92.0, 93.0], session_type=["R", "R"]))
    with pytest.raises(ValueError, match="no 'Q' session laps"):
        B.build_quali_design(race_only)
    with pytest.raises(ValueError, match="no 'Q' session laps"):
        ml.build_training_frame(race_only)
    assert B.build_quali_design(race_only, session_type=None).n_rows == 2


def test_logp_equals_jax(world):
    """logp at 5 seeded thetas, rtol 1e-5."""
    design = B.build_quali_design(world[0])
    logp, _, sizes = B.make_log_posterior(design, "cpu")
    jlogp, jsizes = JB.make_log_posterior(JB.build_quali_design(world[0]))
    assert sizes == jsizes
    theta = _thetas(design, 5, seed=0, spread=0.5)
    want = np.asarray(jax.jit(jax.vmap(jlogp))(jnp.asarray(theta)))
    np.testing.assert_allclose(logp(torch.from_numpy(theta)).numpy(), want, rtol=LOGP_RTOL)


def test_grad_equals_jax_grad(world):
    """The hand-written gradient against jax.grad, rtol 1e-4, atol 1e-4."""
    design = B.build_quali_design(world[0])
    _, grad, _ = B.make_log_posterior(design, "cpu")
    jgrad = jax.jit(jax.vmap(jax.grad(JB.make_log_posterior(JB.build_quali_design(world[0]))[0])))
    for spread, seed in ((0.5, 1), (0.05, 2)):
        theta = _thetas(design, 5, seed=seed, spread=spread)
        want = np.asarray(jgrad(jnp.asarray(theta)))
        np.testing.assert_allclose(grad(torch.from_numpy(theta)).numpy(), want,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_constrain_equals_jax(world):
    design = B.build_quali_design(world[0])
    sizes = (len(design.teams), len(design.drivers), len(design.circuits))
    theta = _thetas(design, 3, seed=4, spread=0.5)
    got = B.constrain(torch.from_numpy(theta), sizes)
    for i, t in enumerate(theta):
        want = JB.constrain(jnp.asarray(t), sizes)
        for k, v in want.items():
            np.testing.assert_allclose(got[k][i].numpy(), np.asarray(v), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("n_steps", [1, 5, 48])
def test_leapfrog_equals_jax(world, n_steps):
    """One trajectory per chain from the same (theta, p, eps, inv_mass):
    rtol 1e-4, atol 1e-3 on positions and momenta."""
    design = B.build_quali_design(world[0])
    _, grad, _ = B.make_log_posterior(design, "cpu")
    jgrad = jax.grad(JB.make_log_posterior(JB.build_quali_design(world[0]))[0])
    rng = np.random.default_rng(3)
    theta = _thetas(design, 4, seed=5, spread=0.05)
    p = rng.standard_normal(theta.shape).astype(np.float32)
    inv_mass = rng.uniform(0.5, 1.5, theta.shape).astype(np.float32)
    eps = np.array([0.001, 0.002, 0.0015, 0.0025], np.float32)
    got_th, got_p = hmc_kernel.leapfrog(torch.from_numpy(theta), torch.from_numpy(p),
                                         torch.from_numpy(eps), torch.from_numpy(inv_mass), grad,
                                         n_steps)
    want_th, want_p = jax.jit(jax.vmap(lambda t, m, e, im: JB._leapfrog(t, m, e, im, jgrad, n_steps)))(
        jnp.asarray(theta), jnp.asarray(p), jnp.asarray(eps), jnp.asarray(inv_mass))
    np.testing.assert_allclose(got_th.numpy(), np.asarray(want_th), rtol=LEAPFROG_RTOL, atol=LEAPFROG_ATOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=LEAPFROG_RTOL, atol=LEAPFROG_ATOL)


def test_split_rhat_is_exact(posteriors):
    port, ref = posteriors
    for raw in (port.raw, ref.raw, np.random.default_rng(0).standard_normal((4, 101, 7))):
        np.testing.assert_array_equal(B.split_rhat(raw), JB.split_rhat(raw))


def _jax_draws(n_draws, n, seed):
    """The rookie and noise draws of JAX's quali_position_probs
    (monte_carlo_gp_tpu/models/bayesian.py:506-511)."""
    k_rookie, k_noise = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.normal(k_rookie, (n_draws, n), jnp.float32)),
            np.asarray(jax.random.normal(k_noise, (n_draws, n), jnp.float32)))


@pytest.mark.parametrize("field, circuit", [
    (DRIVERS, "C0"), (DRIVERS + ["ROOKIE"], "UNSEEN_CIRCUIT")], ids=["field", "rookie_unseen"])
def test_position_probs_equal_jax_on_jax_posterior_and_draws(posteriors, field, circuit):
    """The JAX posterior's arrays and JAX's own draws give exactly JAX's
    grid distributions (tolerance: none)."""
    _, ref = posteriors
    teams = dict(TEAM_OF, ROOKIE="BRAND_NEW_TEAM")
    as_port = B.QualiPosterior(**{f.name: getattr(ref, f.name) for f in
                                  B.QualiPosterior.__dataclass_fields__.values()
                                  if f.name != "design"},
                               design=B.QualiDesign(**{k: getattr(ref.design, k) for k in
                                                       B.QualiDesign.__dataclass_fields__}))
    got = B.quali_position_probs(as_port, field, teams, circuit,
                                 draws=_jax_draws(ref.n_draws, len(field), 3))
    assert got == JB.quali_position_probs(ref, field, teams, circuit, seed=3)


# ------------------------------------------------------------ the sampler, statistically


def test_posterior_agrees_with_jax(posteriors):
    port, ref = posteriors
    np.testing.assert_allclose(total_pace(port), total_pace(ref), rtol=0, atol=TOTAL_ATOL)
    assert abs(port.sigma.mean() / ref.sigma.mean() - 1.0) < SIGMA_RTOL
    for field, circuit in ((DRIVERS, "C0"), (DRIVERS, "C3")):
        got = B.quali_position_probs(port, field, TEAM_OF, circuit, seed=3)
        want = JB.quali_position_probs(ref, field, TEAM_OF, circuit, seed=3)
        pole = np.array([[got[d][0], want[d][0]] for d in field])
        assert 0.5 * np.abs(pole[:, 0] - pole[:, 1]).sum() < POLE_TV, pole
    assert port.raw.shape == ref.raw.shape == (4, 1000, B._param_dim(port.design))
    assert port.raw.dtype == np.float32 and port.accept_rate.shape == (4,)


def test_posterior_recovers_generating_effects(world, posterior):
    _, truth = world
    assert np.corrcoef(total_pace(posterior), truth["total"])[0, 1] > 0.95
    # generating noise 0.08 gap-percent, truncation at 0 biases it low
    assert 0.04 < float(posterior.sigma.mean()) < 0.16


def test_chains_converge(posterior):
    assert float(B.split_rhat(posterior.raw).max()) < 1.15
    assert np.all(posterior.accept_rate > 0.6)
    assert np.all(posterior.accept_rate < 0.99)


# ------------------------------------------------------------ grid probabilities


def test_position_probs_are_distributions(posterior):
    probs = B.quali_position_probs(posterior, DRIVERS, TEAM_OF, "C0", seed=3)
    arr = np.array([probs[d] for d in DRIVERS])
    assert arr.shape == (len(DRIVERS), len(DRIVERS))
    np.testing.assert_allclose(arr.sum(axis=1), 1.0, atol=1e-9)
    np.testing.assert_allclose(arr.sum(axis=0), 1.0, atol=1e-9)
    assert (arr >= 0).all()


def test_fastest_driver_most_likely_on_pole(world, posterior):
    laps, _ = world
    probs = B.quali_position_probs(posterior, DRIVERS, TEAM_OF, "C0", seed=3)
    fastest = laps.groupby("circuit")["LapTime"].transform("min")
    gap = (laps["LapTime"] - fastest) / fastest * 100.0
    ranked = gap.groupby(laps["Driver"]).mean().sort_values()
    pole = {d: probs[d][0] for d in DRIVERS}
    # the data's top two are statistically tied (tests/test_bayesian.py)
    top2 = set(ranked.index[:2])
    assert max(pole, key=pole.get) in top2
    assert sum(pole[d] for d in top2) > 0.8


def test_unseen_driver_and_circuit_get_prior_spread(posterior):
    field = DRIVERS + ["ROOKIE"]
    teams = dict(TEAM_OF, ROOKIE="BRAND_NEW_TEAM")
    probs = B.quali_position_probs(posterior, field, teams, "UNSEEN_CIRCUIT", seed=3)
    arr = np.array([probs[d] for d in field])
    np.testing.assert_allclose(arr.sum(axis=1), 1.0, atol=1e-9)
    r = np.array(probs["ROOKIE"])
    assert (r > 0).sum() >= 3
    expected_pos = float((r * np.arange(len(field))).sum())
    assert 1.0 < expected_pos < len(field) - 2.0


def test_position_probs_seeded(posterior):
    a = B.quali_position_probs(posterior, DRIVERS, TEAM_OF, "C0", seed=3)
    b = B.quali_position_probs(posterior, DRIVERS, TEAM_OF, "C0", seed=3)
    c = B.quali_position_probs(posterior, DRIVERS, TEAM_OF, "C0", seed=4)
    assert a == b
    assert a != c
    rookie_z, noise = B.predictive_draws(posterior.n_draws, len(DRIVERS), 3)
    assert rookie_z.shape == noise.shape == (posterior.n_draws, len(DRIVERS))
    assert a == B.quali_position_probs(posterior, DRIVERS, TEAM_OF, "C0", draws=(rookie_z, noise))
