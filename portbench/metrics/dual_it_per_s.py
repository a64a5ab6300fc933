"""MMA iterations completed in the window over the window's length (host clock),
re-initialisations and bound checks included."""


def read(summary):
    return summary["iterations"] / summary["window_s"]
