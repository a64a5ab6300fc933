"""Share of the traced slice in which no device operation ran (the union of
kernel, copy and fill intervals, against the slice's host span)."""


def read(summary):
    if summary["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
