"""The device's idle share of the traced window: 100 x (1 - the union of
its kernel, copy and memset intervals over the window's length), from
`torch.profiler`."""


def read(run):
    t = run.device_trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
