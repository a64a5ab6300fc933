"""Device milliseconds of every operation outside the sweep library (the exchange,
the bound, the cost updates, copies and fills) per MMA iteration of the slice."""
from portbench.devtrace import is_sweep


def read(summary):
    ns = sum(e - s for name, s, e in summary["device"] if not is_sweep(name))
    if ns <= 0:
        return None
    return ns / 1e6 / summary["iterations"]
