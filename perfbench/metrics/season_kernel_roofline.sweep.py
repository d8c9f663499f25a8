"""The season kernel's share of its roofline over the traced window's
sweeps: the least time the card could take for every launch's races, each
at its own field and laps (the larger of its shape-only float32 operations
at 67 TFLOP/s and its bytes at 3.35 TB/s, `perfbench/roofline.py`), over
the summed device time of the kernels named `season_kernel`. Nothing is
read where no such kernel ran."""

from perfbench import roofline


def read(run):
    t, w = run.device_trace, run.work
    kernel_s = t.kernel_time("season_kernel") if t is not None else 0.0
    if kernel_s <= 0 or not w.get("launches"):
        return None
    n = w["n_simulations"]
    bound = sum(roofline.bound_s(roofline.race_flops(d, laps, n), roofline.race_bytes(d))
                for races in w["launches"] for d, laps in races)
    return 100.0 * bound / kernel_s
