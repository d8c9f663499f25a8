"""The HMC kernel's share of its roofline over the traced window's fits:
the least time the card could take for each fit's three stages (the float64
product over the non-zero counts of C that the benchmark counts from each
race's archive, at 34 TFLOP/s, against the float32 work at 67 TFLOP/s and
the bytes at 3.35 TB/s, `perfbench/roofline.py`), over the summed device
time of the kernels named `hmc_kernel` (the stage launches). Nothing is read where no such kernel
ran."""

from perfbench import roofline


def read(run):
    t, w = run.device_trace, run.work
    kernel_s = t.kernel_time("hmc_kernel") if t is not None else 0.0
    if kernel_s <= 0 or not w.get("fits"):
        return None
    f = w["fit"]
    per_season = sum(roofline.fit_bound_s(k, nnz, f["chains"], f["leapfrog"], f["warmup"],
                                          f["samples"]) for k, nnz in w["fits"])
    return 100.0 * w["seasons"] * per_season / kernel_s
