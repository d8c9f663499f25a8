"""The yardstick of the kernels' roofline shares: the card's peaks and the
operations and bytes of the work, counted from the cell's shapes and inputs
and never read from the program, so the count stays the same whatever
implements the work. Frozen copies of `chip_smoke.py`'s `race_flops`,
`race_bytes`, `bound`, `hmc_ops` and `hmc_bytes` as they stood when the
benchmark was written, with the race's data-dependent overtake term left
out (so the race share is a floor).

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, outside the
tensor cores: 67 TFLOP/s in float32, 34 TFLOP/s in float64 (the HMC
kernel's C·eff is one vector per chain, 4 chains: the float64 tensor core's
smallest product, m8n8k4, would carry 4 of its 8 columns, at most 33.5
TFLOP/s of this work), 3.35 TB/s of HBM. A card set below 700 W
(`nvidia-smi --query-gpu=power.limit`) reaches less; the harness prints the
limit beside the shares.
"""

from __future__ import annotations

HBM_BYTES_PER_S, F32_FLOPS_PER_S, F64_FLOPS_PER_S = 3.35e12, 67e12, 34e12


def race_flops(d: int, laps: int, n_sims: int) -> int:
    """float32 operations of `n_sims` races of `d` cars over `laps` laps
    that the shapes alone fix, counted per car from the race body (add, sub,
    mul, min, max, floor, sqrt, log, cos, negation; compares, selects,
    shuffles, integer and Philox work not counted):
      * grid, per slot: two 5-step warp maxima, the uniform and its clamp,
        the Gumbel -log(-log(u)) and the add: 17;
      * lap 1: the DNF draw, two normals (9 each), the clean lap time (10),
        the start model, the state update, the leader and the rank key: 49;
      * each further lap: race control (21), the DNF draw and normal (10),
        the clean lap time (10), dirty air (2), the state update (5), the
        pit window (2), pace (3), the position update (8): 61.
    The overtake passes, whose number depends on the draws, are left out."""
    return n_sims * d * (17 * d + 49 + (laps - 1) * 61)


def race_bytes(d: int) -> int:
    """One race's inputs read once and its histogram written once: pmat
    (d, 8), 24 scalars, grid_log (d, d) float32, counts (d, d) int32."""
    return 4 * (d * 8 + 24 + d * d + d * d)


def hmc_ops(k: int, nnz: int, chains: int, n_leapfrog: int, iters: int = 1,
            adapt: bool = False) -> tuple[int, int]:
    """(float64, float32) operations of `iters` transitions of `chains`
    chains at k effect columns, as these inputs need them (an exp, a sqrt or
    a division as one; tree reductions' adds not counted):
      * per gradient, float64: the product C·eff's multiply and add for each
        of the `nnz` non-zero counts of C, the four range sums and b (4 K),
        sum(err^2)'s subtract, multiply and add (3 K) and y^T y (1);
        float32: 10 per effect column (its gradient 7, the next effect 3),
        5 per parameter (the momentum and position updates) and 25 for the
        scalars;
      * per transition, float32: the momentum (2 per parameter), the two
        kinetic energies (3 per parameter each), logp (2 per effect column
        and 20) and the accept (10);
      * per warmup iteration, float32: the dual averaging (10) and, over the
        stage's second half, Welford (5 per parameter)."""
    dim = 5 + k
    grads = chains * iters * (n_leapfrog + 1)
    f64 = grads * (2 * nnz + 7 * k + 1)
    f32 = grads * (10 * k + 5 * dim + 25) + chains * iters * (8 * dim + 2 * k + 30)
    if adapt:
        f32 += chains * (10 * iters + 5 * dim * (iters - iters // 2))
    return f64, f32


def hmc_bytes(k: int, chains: int, iters: int = 1, trace: bool = False) -> int:
    """C (k x k) and b read once in float64; theta and inv_mass (chains, 5 +
    k), eps and lp in; per iteration z (chains, 5 + k), u_jit and u_acc in;
    theta, lp and alpha out; with `trace`, per iteration theta, lp, the step
    size and alpha out; all float32 (each read or written once)."""
    dim = 5 + k
    n_in = 8 * (k * k + k) + 4 * chains * (2 * dim + 2) + 4 * iters * chains * (dim + 2)
    n_out = 4 * chains * (dim + 2) + (4 * iters * chains * (dim + 3) if trace else 0)
    return n_in + n_out


def bound_s(flops: float, n_bytes: float, f64_flops: float = 0.0) -> float:
    """The least time the card could take for `flops` float32 and
    `f64_flops` float64 operations and `n_bytes` moved: the slower of the
    operations (the two types run on separate units) and the bytes."""
    ops = max(flops / F32_FLOPS_PER_S, f64_flops / F64_FLOPS_PER_S)
    return max(ops, n_bytes / HBM_BYTES_PER_S)


def fit_bound_s(k: int, nnz: int, chains: int, n_leapfrog: int, warmup: int,
                samples: int) -> float:
    """The bound of one fit: its two warmup stages and its sampling stage,
    each a launch that writes its trace."""
    w1 = max(warmup // 2, 1)
    total = 0.0
    for iters, adapt in ((w1, True), (max(warmup - w1, 1), True), (samples, False)):
        f64, f32 = hmc_ops(k, nnz, chains, n_leapfrog, iters, adapt)
        total += bound_s(f32, hmc_bytes(k, chains, iters, trace=True), f64)
    return total
