"""The bytes the slice's half-sweeps and runs need (portbench.work, from the
instance's real nodes) at the card's memory rate, over the sweep kernels' device
time: a share of the memory roofline."""
from portbench.devtrace import is_sweep


def read(summary):
    ns = sum(e - s for name, s, e in summary["device"] if is_sweep(name))
    peak = summary.get("peak_bytes_per_s")
    if ns <= 0 or not peak:
        return None
    return 100.0 * summary["sweep_bytes"] / peak / (ns / 1e9)
