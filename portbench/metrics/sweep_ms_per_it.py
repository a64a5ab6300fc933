"""Device milliseconds of the program's sweep kernels (found by name) per MMA
iteration of the traced slice."""
from portbench.devtrace import is_sweep


def read(summary):
    ns = sum(e - s for name, s, e in summary["device"] if is_sweep(name))
    if ns <= 0:
        return None
    return ns / 1e6 / summary["iterations"]
