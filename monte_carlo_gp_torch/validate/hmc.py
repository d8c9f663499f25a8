"""The HMC transition kernel held to its plain version on the card, at states
from a real fit (`chip_smoke.py` phase (a), tests/test_torch_bayesian_gpu.py),
and the kernel fit's mixing against the graphed fit's over seeds.

`recorded_transitions` keeps the inputs of chosen transitions of the fits
run inside it; `kernel_vs_plain` runs the kernel and the plain version
(`make_log_posterior`, `hmc_transition_plain`) on the same inputs and
reports their differences against the tolerances:

  * logp and its gradient, rtol 1e-4 and atol 1e-2: float32 sums of up to
    ~5,100 terms of order one in another order, whose worst case is
    log2(N) · 2^-24 · sum|terms| ~ 4e-3;
  * one transition: alpha (what dual averaging reads; it carries lp' and
    both kinetic energies) and lp' at the same tolerance, theta' at rtol
    1e-4 and atol 1e-4 (on the card the two read at most 5e-6 apart);
    theta' and lp' on the chains where both made the same accept decision,
    alpha on every chain; the decision the same wherever |u_acc - alpha| >
    1e-3.

`rhat_by_seed` fits one design per seed through the kernel and through the
graphed fit (bitwise the eager fit) and reports each fit's max split R-hat
and acceptance. On the card:

    python -m monte_carlo_gp_torch.validate.hmc [--seeds 42,1,2,3,4,5,6,7]

fits the synthetic archive before Bahrain 2024 at the default budget and
prints one JSON line per seed, then a summary line: each route's R-hat
quartiles and the number of seeds whose kernel fit read a higher R-hat than
the graphed fit (about half of them when the kernel mixes as the eager
transition does).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
import time

import numpy as np
import torch

from monte_carlo_gp_torch.ops import hmc_kernel

RTOL, ATOL = 1e-4, 1e-2
THETA_ATOL = 1e-4
ALPHA_MARGIN = 1e-3
_INPUTS = ("theta", "lp", "eps", "inv_mass", "z", "u_jit", "u_acc")


@contextlib.contextmanager
def recorded_transitions(iterations):
    """Within the block, every fit's schedule runs as before, and the inputs
    of its transitions numbered `iterations` (0-based, per fit) are cloned
    into the yielded list as dicts of `hmc_transition`'s inputs."""
    from monte_carlo_gp_torch.models import bayesian as B

    kept, real = [], B._schedule
    wanted = set(iterations)

    def schedule(theta0, logp_fn, step, n_warmup, n_samples, draws):
        count = 0

        def recording(*inputs):
            nonlocal count
            if count in wanted:
                kept.append({k: x.clone() for k, x in zip(_INPUTS, inputs)})
            count += 1
            return step(*inputs)

        return real(theta0, logp_fn, recording, n_warmup, n_samples, draws)

    B._schedule = schedule
    try:
        yield kept
    finally:
        B._schedule = real


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
            got = hmc_kernel.hmc_transition(kd, n_leapfrog=n_leapfrog, **s)
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


def rhat_by_seed(design, seeds, device, **budget) -> list[dict]:
    """Per seed, the max split R-hat, the mean acceptance and the wall
    seconds of a kernel fit (`sample_posterior`) and a graphed fit
    (`sample_posterior_graphed`, bitwise the eager fit) of `design` on
    `device`; `budget` goes to both (num_warmup, num_samples, ...)."""
    from monte_carlo_gp_torch.models import bayesian as B

    rows = []
    for seed in seeds:
        row = {"seed": int(seed)}
        for name, fit in (("kernel", B.sample_posterior), ("graph", B.sample_posterior_graphed)):
            t0 = time.perf_counter()
            post = fit(design, seed=int(seed), device=device, **budget)
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
    for name in ("kernel", "graph"):
        r = np.array([row[name]["rhat"] for row in rows])
        q1, median, q3 = np.percentile(r, [25, 50, 75]).tolist()
        summary[name] = {"rhat_min": float(r.min()), "rhat_q1": q1, "rhat_median": median,
                         "rhat_q3": q3, "rhat_max": float(r.max())}
    # seeds whose kernel fit mixed worse than the graphed fit of the same seed
    summary["kernel_above_graph"] = sum(r["kernel"]["rhat"] > r["graph"]["rhat"] for r in rows)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
