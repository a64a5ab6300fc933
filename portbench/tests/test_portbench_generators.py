"""The instance generators: the class rules of Chu and Beasley's, and the frozen
graph-matching copy against the program's own generator and writer."""
import math

import numpy as np
import pytest

from portbench.generators import chu_beasley, graph_matching

SEEDS = [0, 7, 2**31 + 11, 2**33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("tightness", [0.25, 0.5, 0.75])
def test_chu_beasley_keeps_the_class_rules(seed, tightness):
    w, cap, profit = chu_beasley.draw(5, 100, tightness, seed)
    assert w.shape == (5, 100) and w.dtype == np.int64
    assert w.min() >= 0 and w.max() <= chu_beasley.MAX_WEIGHT
    assert (cap == [math.floor(tightness * int(s)) for s in w.sum(1)]).all()
    extra = (profit - w.sum(0) / 5) / chu_beasley.PROFIT_SPREAD
    assert (extra >= 0).all() and (extra < 1).all()
    again = chu_beasley.draw(5, 100, tightness, seed)
    assert all(np.array_equal(a, b) for a, b in zip((w, cap, profit), again))


def test_chu_beasley_model_is_the_draw():
    w, cap, profit = chu_beasley.draw(3, 30, 0.5, 4)
    m = chu_beasley.make({"rows": 3, "items": 30, "tightness": 0.5}, 4)
    assert np.allclose(m.costs(), -profit, rtol=1e-11, atol=0)
    for i, r in enumerate(m.rows):
        assert r.sense == "<=" and r.rhs == cap[i]
        assert r.coeffs == [int(x) for x in w[i][w[i] != 0]]
        assert r.vars == [int(j) for j in np.nonzero(w[i])[0]]


@pytest.mark.parametrize("seed", SEEDS)
def test_frozen_graph_matching_gives_the_programs_lp_text(seed):
    from bdd_tpu_torch.frontends.graph_matching import construct_graph_matching_ilp
    from bdd_tpu_torch.utils.problems import graph_matching as program_gm

    params = {"n_left": 14, "n_right": 12, "candidates": 4, "nr_quadratic": 40}
    ours = graph_matching.make(params, seed).lp_text()
    theirs = construct_graph_matching_ilp(program_gm(14, 12, seed=seed, candidates=4,
                                                     nr_quadratic=40))[0].write_lp()
    assert ours == theirs
