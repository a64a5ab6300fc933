"""The work a dual iteration needs: bytes of the sweeps, and the card's peaks.

Counted from the plain reference's BDDs (:class:`portbench.reference.Layout`),
whose nodes are those of the canonical quasi-reduced BDD of each row, so the
count is the same whatever layout, padding or sweep body the program uses.
Every input is read once and every output written once:

- a half-sweep, per (BDD, level) slot: lo, hi and the two exchanged sums in,
  lo, hi and the deferred marginal out (7 values); per node: its two arcs
  and one frontier value in (the cost to, or from, the terminal) and one out;
- the run (costs to the terminal of fresh costs), per slot lo and hi in, per
  node its arcs in and one value out.

An arc is the index of a node of the BDD's next level or one of the two
terminals, in the fewest whole bytes (1, 2 or 4) that hold that many codes.
"""
from __future__ import annotations

import json
import os

import numpy as np

from portbench.reference import Layout

SLOT_VALUES = 7
RUN_SLOT_VALUES = 2


def _arc_bytes(codes: np.ndarray) -> np.ndarray:
    return np.where(codes <= 1 << 8, 1, np.where(codes <= 1 << 16, 2, 4))


def node_arc_bytes(layout: Layout) -> int:
    """Bytes of both arcs of every node."""
    levels = len(layout.node_start) - 1
    level = np.repeat(np.arange(levels), np.diff(layout.node_start))
    per = np.bincount(level * layout.nr_bdds + layout.node_bdd,
                      minlength=(levels + 1) * layout.nr_bdds).reshape(levels + 1, -1)
    nxt = per[level + 1, layout.node_bdd]  # nodes of the next level of the node's BDD
    return int(2 * _arc_bytes(nxt + 2).sum())


def half_sweep_bytes(layout: Layout, itemsize: int) -> int:
    return (layout.nr_slots * SLOT_VALUES * itemsize + node_arc_bytes(layout)
            + 2 * layout.nr_nodes * itemsize)


def run_bytes(layout: Layout, itemsize: int) -> int:
    return (layout.nr_slots * RUN_SLOT_VALUES * itemsize + node_arc_bytes(layout)
            + layout.nr_nodes * itemsize)


def peaks(device_name: str) -> dict:
    """The published peaks of the card whose name holds a key of the table."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as fh:
        table = json.load(fh)["cards"]
    for key, peak in table.items():
        if key in device_name:
            return peak
    return {}
