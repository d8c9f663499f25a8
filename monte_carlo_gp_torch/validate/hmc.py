"""The HMC kernel held to itself, to its plain version and to a host replay
of its adaptation on the card, at states from a real fit (`chip_smoke.py`
phase (a), tests/test_torch_bayesian_gpu.py), and the kernel fit's mixing
against the eager fit's over seeds.

`recorded_transitions` keeps, for chosen iterations of the fits run inside
it, each transition's inputs as the stage's trace gives them (theta and lp
of the iteration before, or of the stage's start; the step size the trace
says was used; the stage's mass; the iteration's draws) beside the trace's
outputs of that iteration, and every stage's inputs and result. Then:

  * `trace_vs_entry` runs the one-transition entry (`hmc_transition`) on
    each recorded state: it runs the stage's own device code, so it must
    give the trace's (theta', lp', alpha) bitwise;
  * `kernel_vs_plain` runs the kernel and the plain version
    (`make_log_posterior`, `hmc_transition_plain`) on the same inputs and
    reports their differences against the tolerances: logp and its
    gradient, rtol 1e-4 and atol 1e-2 (the plain version's float32 sums of
    up to ~5,100 terms of order one, whose worst case is log2(N) · 2^-24 ·
    sum|terms| ~ 4e-3); one transition: alpha (what dual averaging reads;
    it carries lp' and both kinetic energies) and lp' at the same tolerance,
    theta' at rtol 1e-4 and atol 1e-4; theta' and lp' on the chains where
    both made the same accept decision, alpha on every chain; the decision
    the same wherever |u_acc - alpha| > 1e-3;
  * `adaptation_vs_replay` replays each warmup stage's dual averaging and
    Welford variance on the host (`hmc_kernel.replay_adaptation`, float32 on
    the CPU) from the trace's alphas and thetas: the step size of every
    iteration and the final one within rtol 1e-5 (the card's expf and logf
    and the host's differ by an ulp or two: each log-step-size, ~5 in
    magnitude, moves by ~1e-6, so the step sizes by ~1e-6 relative; nothing
    feeds a step size back into the sums), the variance and the mean alpha
    within rtol 1e-6 (their adds, multiplies and divisions are IEEE float32
    on both sides, so they are expected bitwise; the report says whether).

`rhat_by_seed` fits one design per seed through the kernel and through the
eager fit (`sample_posterior(..., plain=True)`, the plain version) and
reports each fit's max split R-hat and acceptance. On the card:

    python -m monte_carlo_gp_torch.validate.hmc [--seeds 42,1,2,3,4,5,6,7]

fits the synthetic archive before Bahrain 2024 at the default budget and
prints one JSON line per seed, then a summary line: each route's R-hat
quartiles and the number of seeds whose kernel fit read a higher R-hat than
the eager fit (about half of them when the kernel mixes as the eager
transition does). It raises, after the summary, unless the two medians lie
within 0.05 and that number within a fair coin's 95% range (n/2 ± sqrt(n)
over the n seeds whose two fits differ: 11-21 of 32). The eager fit
launches each operation of a transition on its own: ~20 ms a transition on
an H100, so 40-60 s a seed at the default 1000 + 1000 iterations, against
~0.15 s for the kernel fit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import tempfile
import time

import numpy as np
import torch

from monte_carlo_gp_torch.ops import hmc_kernel

RTOL, ATOL = 1e-4, 1e-2
THETA_ATOL = 1e-4
ALPHA_MARGIN = 1e-3
EPS_RTOL, VAR_RTOL = 1e-5, 1e-6
MEDIAN_ATOL = 0.05
_INPUTS = ("theta", "lp", "eps", "inv_mass", "z", "u_jit", "u_acc")


@dataclasses.dataclass
class Recording:
    """What `recorded_transitions` keeps: `states`, per chosen iteration a
    dict of `hmc_transition`'s inputs and, under "want", the trace's (theta',
    lp', alpha); `stages`, per stage run a dict of its inputs ("theta",
    "eps0", "inv_mass", "draws", "adapt"), its `hmc_kernel.Stage` ("out")
    and its wall seconds ("s", the device synchronised before and after)."""

    states: list = dataclasses.field(default_factory=list)
    stages: list = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def recorded_transitions(iterations):
    """Within the block, every fit's schedule runs as before; the iterations
    numbered `iterations` (0-based, per fit) and every stage of every fit
    are kept in the yielded `Recording` (a stage's "s" is the wall time of
    the stage call that ran it, every fit of a batch together)."""
    from monte_carlo_gp_torch.models import bayesian as B

    rec, real = Recording(), B._staged_all
    wanted = set(iterations)

    def staged_all(theta0s, stages, n_warmup, draws):
        count = 0

        def recording(thetas, eps0s, inv_masses, stage_draws, adapt):
            nonlocal count
            starts = [dict(theta=theta.clone(), eps0=eps0.clone(), inv_mass=inv_mass.clone(),
                           draws=d, adapt=adapt)
                      for theta, eps0, inv_mass, d in zip(thetas, eps0s, inv_masses, stage_draws)]
            sync = torch.cuda.synchronize if thetas[0].is_cuda else (lambda: None)
            sync()
            t0 = time.perf_counter()
            outs = stages(thetas, eps0s, inv_masses, stage_draws, adapt)
            sync()
            seconds = time.perf_counter() - t0
            for start, out in zip(starts, outs):
                rec.stages.append({**start, "out": out, "s": seconds})
                z, u_jit, u_acc = start["draws"]
                for j in range(z.shape[0]):
                    if count + j not in wanted:
                        continue
                    before = ((start["theta"], out.lp0) if j == 0
                              else (out.trace_theta[j - 1], out.trace_lp[j - 1]))
                    inputs = (*before, out.trace_eps[j], start["inv_mass"], z[j], u_jit[j],
                              u_acc[j])
                    state = {k: x.clone().contiguous() for k, x in zip(_INPUTS, inputs)}
                    state["want"] = (out.trace_theta[j].clone(), out.trace_lp[j].clone(),
                                     out.trace_alpha[j].clone())
                    rec.states.append(state)
            count += stage_draws[0][0].shape[0]
            return outs

        return real(theta0s, recording, n_warmup, draws)

    B._staged_all = staged_all
    try:
        yield rec
    finally:
        B._staged_all = real


def _err(a: torch.Tensor, b: torch.Tensor, atol: float = ATOL) -> tuple[float, bool]:
    """(max |a - b|, whether a and b are close at RTOL and `atol`)."""
    if a.numel() == 0:
        return 0.0, True
    return (a.double() - b.double()).abs().max().item(), torch.allclose(a, b, rtol=RTOL, atol=atol)


def kernel_vs_plain(kd: hmc_kernel.KernelDesign, states: list[dict], n_leapfrog: int) -> dict:
    """The kernel against the plain version at each state (inputs of
    `hmc_transition` on kd's CUDA device): logp and gradient at theta, and
    one transition. Returns the largest differences, the accept decisions
    that differ (and how many of those lie outside ALPHA_MARGIN), and `ok`."""
    out = {"logp": 0.0, "grad": 0.0, "theta": 0.0, "lp": 0.0, "alpha": 0.0, "decisions_differ": 0,
           "decisions_differ_outside_margin": 0, "states": len(states), "chains": 0}
    ok = bool(states)
    with torch.inference_mode():
        for s in states:
            lp, grad = hmc_kernel.hmc_logp(kd, s["theta"], grad=True)
            for key, got, want in (("logp", lp, kd.logp_fn(s["theta"])),
                                   ("grad", grad, kd.grad_fn(s["theta"]))):
                err, close = _err(got, want)
                out[key] = max(out[key], err)
                ok = ok and close
            got = hmc_kernel.hmc_transition(kd, n_leapfrog=n_leapfrog, **_inputs(s))
            want = hmc_kernel.hmc_transition_plain(
                s["theta"], s["lp"], s["eps"], s["inv_mass"], kd.logp_fn, kd.grad_fn, n_leapfrog,
                s["z"], s["u_jit"], s["u_acc"])
            accepted = [s["u_acc"] < alpha for alpha in (got[2], want[2])]
            same = accepted[0] == accepted[1]
            for key, a, b, atol in (("theta", got[0][same], want[0][same], THETA_ATOL),
                                    ("lp", got[1][same], want[1][same], ATOL),
                                    ("alpha", got[2], want[2], ATOL)):
                err, close = _err(a, b, atol)
                out[key] = max(out[key], err)
                ok = ok and close
            differ = ~same
            outside = differ & ((s["u_acc"] - want[2]).abs() > ALPHA_MARGIN)
            out["decisions_differ"] += int(differ.sum())
            out["decisions_differ_outside_margin"] += int(outside.sum())
            out["chains"] += int(same.numel())
    out["ok"] = bool(ok and out["decisions_differ_outside_margin"] == 0)
    return out


def _inputs(state: dict) -> dict:
    return {k: state[k] for k in _INPUTS}


def trace_vs_entry(kd: hmc_kernel.KernelDesign, states: list[dict], n_leapfrog: int) -> dict:
    """The one-transition entry from each recorded state against the stage
    trace's next state: {"states", "chains", "differ" (chains whose theta',
    lp' or alpha differ in any bit), "max_abs" (their largest difference),
    "ok" (none differ)}."""
    out = {"states": len(states), "chains": 0, "differ": 0, "max_abs": 0.0}
    with torch.inference_mode():
        for s in states:
            got = hmc_kernel.hmc_transition(kd, n_leapfrog=n_leapfrog, **_inputs(s))
            same = torch.ones_like(s["lp"], dtype=torch.bool)
            for a, b in zip(got, s["want"]):
                eq = a == b if a.dim() == 1 else (a == b).all(dim=1)
                same &= eq
                out["max_abs"] = max(out["max_abs"], (a.double() - b.double()).abs().max().item())
            out["differ"] += int((~same).sum())
            out["chains"] += int(same.numel())
    out["ok"] = bool(states) and out["differ"] == 0
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).abs() / b.double().abs().clamp(min=1e-30)).max().item()


def adaptation_vs_replay(stages: list[dict]) -> dict:
    """Each warmup stage's step sizes (every iteration's and the final one),
    variance and mean alpha against `hmc_kernel.replay_adaptation` on the
    CPU from the stage's trace: the largest relative differences, whether
    each is bitwise, and `ok` (within EPS_RTOL and VAR_RTOL)."""
    out = {"stages": 0, "eps": 0.0, "final_eps": 0.0, "var": 0.0, "alpha_mean": 0.0}
    bitwise = {k: True for k in ("eps", "final_eps", "var", "alpha_mean")}
    ok = True
    with torch.inference_mode():
        for st in stages:
            if not st["adapt"]:
                continue
            res = st["out"]
            cpu = lambda x: x.detach().cpu()
            want = hmc_kernel.replay_adaptation(cpu(st["eps0"]), cpu(res.trace_theta),
                                                cpu(res.trace_alpha))
            got = {"eps": cpu(res.trace_eps), "final_eps": cpu(res.eps), "var": cpu(res.var),
                   "alpha_mean": cpu(res.alpha_mean)}
            for key, rtol in (("eps", EPS_RTOL), ("final_eps", EPS_RTOL), ("var", VAR_RTOL),
                              ("alpha_mean", VAR_RTOL)):
                out[key] = max(out[key], _rel(got[key], want[key]))
                bitwise[key] = bitwise[key] and torch.equal(got[key], want[key])
                ok = ok and torch.allclose(got[key], want[key], rtol=rtol, atol=0.0)
            out["stages"] += 1
    out["bitwise"] = bitwise
    out["ok"] = bool(ok and out["stages"] > 0)
    return out


def rhat_by_seed(design, seeds, device, **budget) -> list[dict]:
    """Per seed, the max split R-hat, the mean acceptance and the wall
    seconds of a kernel fit (`sample_posterior`) and the eager fit
    (`sample_posterior(..., plain=True)`, the plain version) of `design` on
    `device`; `budget` goes to both (num_warmup, num_samples, ...)."""
    from monte_carlo_gp_torch.models import bayesian as B

    rows = []
    for seed in seeds:
        row = {"seed": int(seed)}
        for name, plain in (("kernel", False), ("plain", True)):
            t0 = time.perf_counter()
            post = B.sample_posterior(design, seed=int(seed), device=device, plain=plain, **budget)
            row[name] = {"rhat": float(B.split_rhat(post.raw).max()),
                         "accept": float(np.mean(post.accept_rate)),
                         "s": time.perf_counter() - t0}
        rows.append(row)
    return rows


def bahrain_design(device):
    """The synthetic archive (seed 2718) an F1Predictor fits before Bahrain
    2024, built in a temporary cache."""
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models import bayesian as B
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    with tempfile.TemporaryDirectory() as cache:
        p = F1Predictor(cache_dir=cache, backend=SyntheticBackend(seed=2718), device=device)
        p.prepare_weekend(2024, "Bahrain")
        return B.build_quali_design(p.feature_engine.laps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="42,1,2,3,4,5,6,7")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--warmup", type=int, default=1000)
    ap.add_argument("--samples", type=int, default=1000)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (use --device cpu)")
        return 1
    design = bahrain_design(device)
    seeds = [int(x) for x in args.seeds.split(",")]
    rows = rhat_by_seed(design, seeds, device, num_warmup=args.warmup, num_samples=args.samples)
    for row in rows:
        print(json.dumps(row))
    summary = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               "rows": design.n_rows, "seeds": seeds}
    for name in ("kernel", "plain"):
        r = np.array([row[name]["rhat"] for row in rows])
        q1, median, q3 = np.percentile(r, [25, 50, 75]).tolist()
        summary[name] = {"rhat_min": float(r.min()), "rhat_q1": q1, "rhat_median": median,
                         "rhat_q3": q3, "rhat_max": float(r.max())}
    # seeds whose kernel fit mixed worse than the eager fit of the same seed,
    # against a fair coin's 95% range over the seeds whose two fits differ
    above = sum(r["kernel"]["rhat"] > r["plain"]["rhat"] for r in rows)
    differ = sum(r["kernel"]["rhat"] != r["plain"]["rhat"] for r in rows)
    lo, hi = math.ceil(differ / 2 - math.sqrt(differ)), math.floor(differ / 2 + math.sqrt(differ))
    gap = abs(summary["kernel"]["rhat_median"] - summary["plain"]["rhat_median"])
    summary.update(kernel_above_plain=above, seeds_differ=differ, above_range=[lo, hi],
                   median_gap=gap, median_atol=MEDIAN_ATOL,
                   ok=bool(gap <= MEDIAN_ATOL and lo <= above <= hi))
    print(json.dumps(summary))
    if not summary["ok"]:
        raise AssertionError(f"the kernel fit's split R-hat departs from the eager fit's over "
                             f"seeds: median gap {gap:.4f} (at most {MEDIAN_ATOL}), kernel higher "
                             f"at {above} of {differ} differing seeds (range {lo}-{hi})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
