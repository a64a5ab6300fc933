"""The plain reference: its BDDs against enumeration, its first bound against the
enumerated dual bound, and its whole solve against the program's CPU path."""
import itertools

import numpy as np
import pytest
import torch

from portbench import harness, reference
from portbench.generators import chu_beasley, graph_matching
from portbench.model import Model


def feasible(coeffs, sense, rhs, x) -> bool:
    s = int(np.dot(coeffs, x))
    return {"<=": s <= rhs, ">=": s >= rhs, "=": s == rhs}[sense]


@pytest.mark.parametrize("seed", range(6))
def test_bdds_accept_exactly_the_feasible_assignments(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        n = int(rng.integers(1, 7))
        c = rng.integers(-4, 5, size=n)
        c[c == 0] = 1
        sense = ("<=", ">=", "=")[int(rng.integers(3))]
        rhs = int(rng.integers(-5, 8))
        ok = [feasible(c, sense, rhs, x) for x in itertools.product((0, 1), repeat=n)]
        if not any(ok):
            with pytest.raises(reference.Infeasible):
                reference.build_bdd(c, sense, rhs)
            continue
        bdd = reference.build_bdd(c, sense, rhs)
        if all(ok):
            assert bdd is None
            continue
        for x, want in zip(itertools.product((0, 1), repeat=n), ok):
            node = 0
            while node >= 0:
                node = (bdd.hi if x[bdd.support[bdd.pos[node]]] else bdd.lo)[node]
            assert (node == reference.TOP) == want
        for i in range(len(bdd.pos)):  # quasi-reduced: one level down, TOP from the last
            for child in (bdd.lo[i], bdd.hi[i]):
                if child >= 0:
                    assert bdd.pos[child] == bdd.pos[i] + 1
                elif child == reference.TOP:
                    assert bdd.pos[i] == len(bdd.support) - 1


def tiny_model(seed: int) -> Model:
    rng = np.random.default_rng(seed)
    m = Model()
    for j in range(7):
        m.add_var(f"y{j}")
        m.objective[j] = float(rng.normal())
    for _ in range(4):
        vs = sorted(rng.choice(7, size=int(rng.integers(2, 5)), replace=False).tolist())
        cs = rng.integers(1, 4, size=len(vs)).tolist()
        m.add_row(cs, vs, "<=", int(sum(cs) // 2))
    m.add_row([1, 1, 1], [0, 3, 6], "=", 1)
    return m


@pytest.mark.parametrize("seed", range(5))
def test_first_bound_is_the_enumerated_dual_bound(seed):
    m = tiny_model(seed)
    L = reference.build_layout(m, "input")
    res = reference.solve(L, 0)
    count = np.bincount(L.slot_var, minlength=L.nr_vars)
    share = m.costs() / np.maximum(count, 1)
    want = 0.0
    b = 0
    for r in m.rows:  # a BDD a row, in row order, where the row is not always met
        if reference.build_bdd(r.coeffs, r.sense, r.rhs) is None:
            continue
        vs = set(L.slot_var[L.slot_bdd == b].tolist())
        want += min(sum(share[v] * x for v, x in zip(r.vars, xs) if v in vs)
                    for xs in itertools.product((0, 1), repeat=len(r.vars))
                    if feasible(r.coeffs, r.sense, r.rhs, xs))
        b += 1
    for free in range(b, L.nr_bdds):  # a variable no row holds: either value
        want += min(0.0, share[L.slot_var[L.slot_bdd == free][0]])
    assert res.lower_bound == pytest.approx(want, rel=1e-12, abs=1e-12)
    optimum = min(
        float(np.dot(m.costs(), x)) for x in itertools.product((0, 1), repeat=7)
        if all(feasible(r.coeffs, r.sense, r.rhs, [x[v] for v in r.vars]) for r in m.rows))
    for it in (1, 5, 30):
        assert reference.solve(L, it).lower_bound <= optimum + 1e-9


CASES = {
    "gm": ("graph_matching", {"n_left": 9, "n_right": 8, "candidates": 3, "nr_quadratic": 25}, "bfs"),
    "knapsack": ("chu_beasley", {"rows": 3, "items": 18, "tightness": 0.5}, "input"),
}


def program_solve(model, order, dtype, iterations):
    from bdd_tpu_torch.native import NativeHost
    from bdd_tpu_torch.solver.layout import from_native_host
    from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver

    nh = NativeHost(model.lp_text(), order)
    host = from_native_host(nh, dtype=dtype, device="cpu")
    sol = UniformSolver(host, nh.objective())
    for _ in range(iterations):
        sol.iteration()
    return nh, host, sol


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_is_the_programs(case):
    gen, params, order = CASES[case]
    m = getattr({"graph_matching": graph_matching, "chu_beasley": chu_beasley}[gen], "make")(params, 3)
    L = reference.build_layout(m, order)
    nh, host, _ = program_solve(m, order, torch.float64, 0)
    names = [m.var_names[i] for i in np.argsort(reference.new_positions(m, order))]
    assert names == nh.var_names()
    assert L.nr_bdds == nh.nr_bdds()
    nodes = np.zeros(L.nr_bdds, dtype=np.int64)
    for k in range(nh.nr_buckets()):
        a = nh.bucket_arrays(k)
        per = a["node_valid"].sum(1)
        for h, b in zip(*np.nonzero(host.layer_bdd[k] >= 0)):
            nodes[host.layer_bdd[k][h, b]] += per[h, b]
    assert (nodes == np.bincount(L.node_bdd, minlength=L.nr_bdds)).all()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("iterations", [0, 1, 20])
def test_solve_is_the_programs_in_float64(case, iterations):
    gen, params, order = CASES[case]
    m = getattr({"graph_matching": graph_matching, "chu_beasley": chu_beasley}[gen], "make")(params, 5)
    L = reference.build_layout(m, order)
    nh, host, sol = program_solve(m, order, torch.float64, iterations)
    cell = type("C", (), {})()
    cell.api = type("A", (), {"solver": sol})()
    cell.host, cell.native, cell.model = host, nh, m
    out = harness.Cell.outputs(cell, sol.lower_bound())
    gaps = harness.compare(out, reference.solve(L, iterations), L)
    assert max(gaps.values()) < 1e-12


@pytest.mark.parametrize("case", sorted(CASES))
def test_scattered_and_padded_minima_agree(case, monkeypatch):
    """Levels whose padding would be too large take their minima by a scatter."""
    gen, params, order = CASES[case]
    m = getattr({"graph_matching": graph_matching, "chu_beasley": chu_beasley}[gen], "make")(params, 9)
    L = reference.build_layout(m, order)
    padded = reference.solve(L, 10)
    monkeypatch.setattr(reference.Solver, "PAD_LIMIT", -10**9)
    s = reference.Solver(L)
    assert all(lv["pad"] is None for lv in s.levels)
    scattered = reference.solve(L, 10)
    assert scattered.lower_bound == padded.lower_bound
    for k in ("lo", "hi", "mm", "bdd_bounds"):
        assert np.array_equal(getattr(scattered, k), getattr(padded, k))
