"""The port's binding of the native C++ oracle
(`monte_carlo_gp_torch.validate.native_oracle`) and the mutation-sensitivity
check it makes possible: an oracle with one rule dropped on purpose must
fail the tolerance that the race kernel's plain version passes against the
real oracle (the JAX template is tests/test_engine_stats.py:270-313).
"""

import numpy as np
import torch

from monte_carlo_gp_torch.config import make_sim_params
from monte_carlo_gp_torch.ops import race_kernel as rk
from monte_carlo_gp_torch.validate import native_oracle as tno
from monte_carlo_gp_tpu.validate import native_oracle as jno

torch.set_num_threads(2)


def scenario(d=10, seed=5):
    """tests/test_engine_stats.py::scenario."""
    rng = np.random.default_rng(seed)
    gp = np.exp(-((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / 6.0).astype(np.float32)
    gp /= gp.sum(axis=1, keepdims=True)
    return dict(
        grid_probs=gp,
        base_pace=(90.0 + 0.12 * np.arange(d) + 0.05 * rng.standard_normal(d)).astype(np.float32),
        tire_deg=np.clip(0.05 + 0.02 * rng.standard_normal(d), 0.01, 0.15).astype(np.float32),
        variance=np.full(d, 0.15, np.float32),
        dnf_rate=np.full(d, 0.001, np.float32),
        team_dnf_rate=np.full(d, 0.002, np.float32),
    )


def test_mutation_ids_equal_the_jax_binding():
    assert (tno.MUT_NONE, tno.MUT_NO_FRONT_ROW_START_CLAMP, tno.MUT_NO_TWO_COMPOUND_RULE) == (
        jno.MUT_NONE, jno.MUT_NO_FRONT_ROW_START_CLAMP, jno.MUT_NO_TWO_COMPOUND_RULE)


def test_mutation_two_compound_rule_is_detected():
    """Every car starts on SOFT (10 cars, all in the top 10); at 24 laps the
    pit window lands at remaining <= 15, so the condition-based pick is SOFT
    again and the two-dry-compound rule fires for most of the field. The
    plain version (32,768 sims) must pass the JAX test's tight bound of TV
    0.012 against the real oracle (100,000 sims; measured 0.004 at 65,536
    vs 400,000 on a CPU), and the oracle without the rule must fail it by
    far (measured 0.098; the JAX test asks for > 0.05)."""
    params = make_sim_params(pit_loss=21.0, overtake_delta=0.6, **scenario())
    laps, n_oracle = 24, 100_000
    plain = rk.run_monte_carlo_kernel(params, 9, 32_768, laps).numpy()
    good = tno.run_native_oracle(params, seed=42, n_sims=n_oracle, total_laps=laps)
    tv_good = 0.5 * np.abs(good - plain).sum(axis=1)
    assert tv_good.max() < 0.012, ("the real rules must pass the tight bound", tv_good)
    mutated = tno.run_native_oracle(params, seed=42, n_sims=n_oracle, total_laps=laps,
                                    mutation=tno.MUT_NO_TWO_COMPOUND_RULE)
    tv_bad = 0.5 * np.abs(mutated - plain).sum(axis=1)
    assert tv_bad.max() > 0.05, ("the dropped rule must blow the tolerance", tv_bad)
