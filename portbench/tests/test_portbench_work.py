"""The byte count of the sweeps on a hand-built instance."""
import pytest

from portbench import reference, work
from portbench.model import Model


def at_most_one_of_three() -> reference.Layout:
    m = Model()
    for j in range(3):
        m.add_var(f"x{j}")
        m.objective[j] = 1.0
    m.add_row([1, 1, 1], [0, 1, 2], "<=", 1)
    return reference.build_layout(m, "input")


def test_the_bdd_of_at_most_one():
    L = at_most_one_of_three()
    # level 0: the root; level 1: "none yet", "one taken"; level 2: the same two
    assert L.nr_bdds == 1 and L.nr_slots == 3 and L.nr_nodes == 5
    assert list(L.node_start) == [0, 1, 3, 5]


@pytest.mark.parametrize("itemsize", [4, 8])
def test_sweep_and_run_bytes(itemsize):
    L = at_most_one_of_three()
    arcs = 2 * 5  # five nodes, two one-byte arcs each (at most 4 codes a level)
    assert work.node_arc_bytes(L) == arcs
    assert work.half_sweep_bytes(L, itemsize) == 3 * 7 * itemsize + arcs + 2 * 5 * itemsize
    assert work.run_bytes(L, itemsize) == 3 * 2 * itemsize + arcs + 5 * itemsize


def test_wide_levels_take_wider_arcs():
    import numpy as np

    assert list(work._arc_bytes(np.array([2, 256, 257, 65536, 65537]))) == [1, 1, 2, 2, 4]


def test_peaks_of_the_card():
    assert work.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert work.peaks("cpu") == {}
