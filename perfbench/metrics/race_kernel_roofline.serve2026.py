"""The race kernel's share of its roofline over the traced window's
requests in the 2026 serve cell: the least time the card could take for
their races at the requests' field (22 cars) and laps (the larger of their
shape-only float32 operations at 67 TFLOP/s and their bytes at 3.35 TB/s,
`perfbench/roofline.py`), over the summed device time of the kernels named
`race_kernel`. Nothing is read where no such kernel ran."""

from perfbench import roofline


def read(run):
    t, w = run.device_trace, run.work
    kernel_s = t.kernel_time("race_kernel") if t is not None else 0.0
    if kernel_s <= 0 or not w.get("requests"):
        return None
    d, laps, n = w["drivers"], w["laps"], w["n_simulations"]
    bound = w["requests"] * roofline.bound_s(roofline.race_flops(d, laps, n), roofline.race_bytes(d))
    return 100.0 * bound / kernel_s
