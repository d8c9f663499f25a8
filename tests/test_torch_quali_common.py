"""The port's shared helpers of the alternative qualifying models
(`monte_carlo_gp_torch.models.quali_common`) against the JAX package's
copy: the archive filter, the Monte Carlo ranking and the fit-cache gate
give exactly the same results (tolerance: none)."""

import numpy as np
import pandas as pd
import pytest

from monte_carlo_gp_torch.models import quali_common as tq
from monte_carlo_gp_tpu.models import quali_common as jq
from torch_quali_world import world as _world


def _spiked(laps):
    extra = pd.DataFrame(
        dict(
            Driver=["Z", "D0", "D1", None],
            Team=["T0", "T0", "T0", "T1"],
            circuit=["C0", "C0", "C1", "C1"],
            LapTime=[np.nan, 70.0, -1.0, 80.0],
            session_type=["Q", "R", "Q", "Q"],
        )
    )
    return pd.concat([laps, extra], ignore_index=True)


@pytest.mark.parametrize("session_type", ["Q", "R", None])
def test_valid_q_rows_equals_jax(session_type):
    laps = _spiked(_world()[0])
    pd.testing.assert_frame_equal(
        tq.valid_q_rows(laps, session_type), jq.valid_q_rows(laps, session_type)
    )


@pytest.mark.parametrize(
    "frame, message",
    [
        (pd.DataFrame(), "No valid lap times"),
        (pd.DataFrame(dict(Driver=["A"], Team=["X"], circuit=["c"], LapTime=[np.nan])),
         "No valid lap times"),
        (pd.DataFrame(dict(Driver=["A"], Team=["X"], LapTime=[80.0])), "No valid lap times"),
        (pd.DataFrame(dict(Driver=["A", "B"], Team=["X", "Y"], circuit=["c1", "c1"],
                           LapTime=[92.0, 93.0], session_type=["R", "R"])),
         "no 'Q' session laps"),
    ],
    ids=["empty", "nan_only", "no_circuit_column", "race_only"],
)
def test_valid_q_rows_raises_as_jax(frame, message):
    with pytest.raises(ValueError, match=message) as got:
        tq.valid_q_rows(frame)
    with pytest.raises(ValueError) as want:
        jq.valid_q_rows(frame)
    assert str(got.value) == str(want.value)


def test_rank_draws_to_probs_equals_jax_exactly():
    """Integer draws make ties common: both break them by driver index."""
    rng = np.random.default_rng(11)
    drivers = [f"D{i}" for i in range(7)]
    for draws in (rng.integers(0, 4, size=(500, 7)).astype(np.float64),
                  rng.standard_normal((300, 7)).astype(np.float32)):
        got = tq.rank_draws_to_probs(draws, drivers)
        assert got == jq.rank_draws_to_probs(draws, drivers)
        arr = np.array([got[d] for d in drivers])
        np.testing.assert_allclose(arr.sum(axis=0), 1.0, atol=1e-12)
        np.testing.assert_allclose(arr.sum(axis=1), 1.0, atol=1e-12)


def test_needs_refit_is_the_jax_gate():
    token, other = object(), object()
    fit = object()
    for cached, frame_token, cached_token in (
        (None, token, token), (fit, None, None), (fit, None, token),
        (fit, token, token), (fit, other, token),
    ):
        assert tq.needs_refit(cached, frame_token, cached_token) == jq.needs_refit(
            cached, frame_token, cached_token
        )
    assert not tq.needs_refit(fit, token, token)
    assert tq.needs_refit(fit, other, token)
