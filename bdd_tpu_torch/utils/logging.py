"""Logging + wall-clock tracing.

Mirrors the reference's joint console/file stream (include/bdd_logging.h:8-33)
and the cumulative per-function timing report of
MEASURE_CUMULATIVE_FUNCTION_EXECUTION_TIME (include/time_measure_util.h:24-71):
timers accumulate per label and can be dumped at exit / on demand.

Copy of bdd_tpu/utils/logging.py. Device-level profiling: set
BDD_TPU_TRACE=/path/to/dir (or call ``device_trace``) to capture a
``torch.profiler`` trace (a Chrome trace file, viewable in Perfetto) around
the solve, the counterpart of the reference's cudaDeviceSynchronize-bracketed
kernel timing in debug builds (bdd_cuda_parallel_mma.cu:130-132).
"""
from __future__ import annotations

import atexit
import contextlib
import sys
import time
from collections import defaultdict
from typing import Optional

_log_file = None
_console = None  # None: sys.stdout as it is when a line is written
_verbosity = 1


def set_console(stream) -> None:
    """Send the console half of the log to ``stream`` (None: sys.stdout). The
    server does so with sys.stderr: its stdout carries only results."""
    global _console
    _console = stream


def set_log_file(path: Optional[str]) -> None:
    global _log_file
    if _log_file is not None:
        _log_file.close()
        _log_file = None
    if path:
        _log_file = open(path, "a")


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = level


def bdd_log(msg: str, level: int = 1) -> None:
    if _verbosity >= level:
        (_console or sys.stdout).write(msg + "\n")
    # the file sink deliberately records EVERYTHING (a silenced console run
    # still leaves a complete trace), matching the reference's joint
    # console+file bdd_log stream (include/bdd_logging.h:8-33)
    if _log_file is not None:
        _log_file.write(msg + "\n")
        _log_file.flush()


_cumulative = defaultdict(float)
_counts = defaultdict(int)


@contextlib.contextmanager
def scoped_timer(label: str, log: bool = False):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _cumulative[label] += dt
        _counts[label] += 1
        if log:
            bdd_log(f"[timer] {label}: {dt:.3f} s")


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None, label: str = "solve"):
    """Capture a torch.profiler trace (host and, where there is one, the
    CUDA device) of the enclosed block into ``trace_dir``/``label``.json.
    ``trace_dir`` defaults to $BDD_TPU_TRACE; a no-op (plus a scoped_timer)
    when unset."""
    import os

    trace_dir = trace_dir or os.environ.get("BDD_TPU_TRACE")
    if not trace_dir:
        with scoped_timer(label):
            yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{label}.json")
    bdd_log(f"[trace] capturing torch.profiler trace of '{label}' to {path}")
    with profile(activities=activities) as prof:
        with scoped_timer(label):
            yield
    prof.export_chrome_trace(path)


def timing_report() -> str:
    lines = ["[timing] cumulative execution times:"]
    for label in sorted(_cumulative, key=lambda k: -_cumulative[k]):
        lines.append(
            f"[timing]   {label}: {_cumulative[label]:.3f} s over {_counts[label]} calls"
        )
    return "\n".join(lines)


def _report_at_exit() -> None:
    if _cumulative and _verbosity >= 2:
        bdd_log(timing_report(), level=2)


atexit.register(_report_at_exit)
