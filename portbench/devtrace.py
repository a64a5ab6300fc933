"""The traced run's reading of ``torch.profiler``: events kept in memory, no file.

The harness wraps a steady slice of the window in :class:`Trace`. Its
:meth:`Trace.summary` gives the metric readers the slice's device intervals
(kernels, copies and fills) and host events, both on the profiler's clock,
with the slice's length taken from a host span the harness records around it.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

WINDOW = "portbench.window"
# the program's sweep library: csrc/uniform_sweep.cu, sweep_kernel and its bodies
SWEEP = re.compile(r"\bsweep_\w*kernel\b")
LAUNCH = re.compile(r"^(cuda|cu)Launch")

Interval = Tuple[str, int, int]  # name, start ns, end ns


def is_sweep(name: str) -> bool:
    return bool(SWEEP.search(name))


def union_ns(intervals: List[Interval], lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] that the intervals cover."""
    total, end = 0, lo
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


class Trace:
    def __init__(self) -> None:
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self.span = None

    def __enter__(self) -> "Trace":
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.span = torch.profiler.record_function(WINDOW)
        self.span.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)

    def summary(self) -> dict:
        device: List[Interval] = []
        host: List[Interval] = []
        window = None
        for e in self.prof.profiler.kineto_results.events():
            item = (e.name(), e.start_ns(), e.end_ns())
            if e.name() == WINDOW:
                # the span shows on the host and, as an annotation, on the device
                if e.device_type() != torch.autograd.DeviceType.CUDA:
                    window = item
            elif e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():
                    device.append(item)
            else:
                host.append(item)
        if window is None:
            raise RuntimeError("the profiler lost the window's span")
        _, lo, hi = window
        device = [d for d in device if d[2] > lo and d[1] < hi]
        host = [h for h in host if h[2] > lo and h[1] < hi]
        return {
            "window_s": (hi - lo) / 1e9,
            "busy_s": union_ns(device, lo, hi) / 1e9,
            "window_ns": (lo, hi),
            "device": device,
            "host": host,
            "launches": sum(1 for h in host if LAUNCH.match(h[0])),
        }


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps of the
    device summed by the innermost host event in progress at their middle."""
    ops: Dict[str, float] = defaultdict(float)
    for name, s, e in summary["device"]:
        ops[_short(name)] += (e - s) / 1e9
    lo, hi = summary["window_ns"]
    host = sorted(summary["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps: Dict[str, float] = defaultdict(float)
    end = lo
    for _, s, e in sorted(summary["device"], key=lambda d: d[1]) + [("", hi, hi)]:
        if s > end:
            mid = (s + end) // 2
            what = "(host between profiled calls: Python)"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 256, -1), -1):
                if host[j][2] >= mid:
                    what = host[j][0]
                    break
            gaps[_short(what)] += (s - end) / 1e9
        end = max(end, e)
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": [[k, v] for k, v in order(ops)],
            "idle_gaps": [[k, v] for k, v in order(gaps)]}
