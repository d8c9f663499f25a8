"""What a `torch.profiler` trace of the measured window says: the device's
busy time (the union of its kernel, copy and memset intervals), each
kernel's summed time, the operations that took the most time, and the
longest idle gaps labelled by the harness span the host was in.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

WINDOW = "window"  # the record_function range around the whole measured window


@dataclass
class DeviceTrace:
    busy_s: float
    window_s: float
    kernel_s: dict[str, float] = field(default_factory=dict)
    device_ops: list[list] = field(default_factory=list)
    idle_gaps: list[list] = field(default_factory=list)

    def kernel_time(self, part: str) -> float:
        """The summed device time of the kernels whose name holds `part`."""
        return sum(t for name, t in self.kernel_s.items() if part in name)

    def as_dict(self) -> dict:
        return {"busy_s": self.busy_s, "window_s": self.window_s, "kernel_s": self.kernel_s,
                "device_ops": self.device_ops, "idle_gaps": self.idle_gaps}


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def gaps(busy: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval of `busy` (disjoint, sorted)
    covers."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def label(gap: tuple[float, float], spans: list[tuple[float, float, str]]) -> str:
    """The harness span that covers most of `gap` (the innermost, the
    shortest, among equals), or "outside spans" where the part of the gap
    that no span covers is longer."""
    best, best_cover, best_len = "outside spans", 0.0, float("inf")
    for a, b, name in spans:
        cover = min(b, gap[1]) - max(a, gap[0])
        if cover > 0 and (cover > best_cover or (cover == best_cover and b - a < best_len)):
            best, best_cover, best_len = name, cover, b - a
    covered = sum(b - a for a, b in union(clip([(a, b) for a, b, _ in spans], *gap)))
    return best if best_cover >= (gap[1] - gap[0]) - covered else "outside spans"


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its parameter list, cut to `width`."""
    return name.replace("(anonymous namespace)::", "").split("(", 1)[0].strip()[:width]


def summarize(device: list[tuple[float, float, str]], spans: list[tuple[float, float, str]],
              window: tuple[float, float], top: int = 10) -> DeviceTrace:
    """The trace of one window from its device events (start, end, name)
    and harness spans (start, end, name), all in one clock's seconds."""
    lo, hi = window
    busy = union(clip([(a, b) for a, b, _ in device], lo, hi))
    kernel_s: dict[str, float] = {}
    for a, b, name in device:
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a)
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:top]
    return DeviceTrace(
        busy_s=sum(b - a for a, b in busy),
        window_s=hi - lo,
        kernel_s=kernel_s,
        device_ops=[[short(name), t] for name, t in ops],
        idle_gaps=[[label(g, spans), g[1] - g[0]] for g in idle],
    )


def _is_device_work(e) -> bool:
    """A kernel, copy or memset the device ran; the device-side copy of a
    `record_function` range is not (as `utils/profiling._device_work`)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def from_profile(prof, span_names: set[str], on_device: bool = True) -> DeviceTrace:
    """The `DeviceTrace` of a finished profile whose window is the
    `record_function(WINDOW)` range; `on_device`: the run used the card, so
    a trace without a device event is a fault."""
    device, spans, window = [], [], None
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if _is_device_work(e):
            device.append((a, b, e.name))
        elif e.device_type == torch.autograd.DeviceType.CPU and e.name == WINDOW:
            window = (a, b)
        elif e.device_type == torch.autograd.DeviceType.CPU and e.name in span_names:
            spans.append((a, b, e.name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    if on_device and not device:
        raise RuntimeError("the profiler recorded no device event in the window")
    return summarize(device, spans, window)


@contextlib.contextmanager
def profiled(enabled: bool, on_device: bool = True):
    """A `torch.profiler.profile` of the CPU and (`on_device`) the CUDA
    device, or nothing. Yields the profile (None when off), finished after
    the block."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_device else [])
    with profile(activities=activities) as prof:
        yield prof
