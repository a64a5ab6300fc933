"""Seconds from the start of the benchmark's process to the first timed iteration
(host clock): imports, the card's context, the instance, the program's build
and layout, and a warm solve of the cell's own shapes."""


def read(summary):
    return summary["setup_s"]
