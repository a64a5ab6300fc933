"""Synthetic geometric graph matching, frozen for the benchmark.

A copy of ``bdd_tpu_torch/utils/problems.py:graph_matching`` (the instance) and
of ``bdd_tpu_torch/frontends/graph_matching.py:construct_graph_matching_ilp``
(its ILP: a simplex per left and per right point with a no-assignment slack,
product variables for the quadratic terms and their marginalisation rows), so
that a change to the program cannot change the yardstick. For a seed it makes
the same LP text as the program's own generator and writer.

Parameters (the configuration's ``instance``): ``n_left``, ``n_right``,
``candidates`` (right points a left point may take), ``nr_quadratic``.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Tuple

from portbench.model import Model

NO_ASSIGNMENT = -1


def instance(n_left: int, n_right: int, seed: int, candidates: int, nr_quadratic: int):
    """(linear, quadratic): assignments (left, right, cost) and quadratic terms
    ((left a, left b), (right a, right b), cost)."""
    rng = random.Random(seed)
    pl = [(rng.random(), rng.random()) for _ in range(n_left)]
    pr = [(rng.random(), rng.random()) for _ in range(n_right)]
    cand = []
    for i, (x, y) in enumerate(pl):
        dists = sorted((math.hypot(x - a, y - b), j) for j, (a, b) in enumerate(pr))[:candidates]
        for d, j in dists:
            cand.append((i, j, d - 0.5))
    quadratic = []
    ids = list(range(len(cand)))
    seen = set()
    attempts = 0
    while len(quadratic) < nr_quadratic and attempts < 20 * max(nr_quadratic, 1):
        attempts += 1
        if len(ids) < 2:
            break
        a, b = rng.sample(ids, 2)
        if (a, b) in seen or (b, a) in seen:
            continue
        ia, ja, _ = cand[a]
        ib, jb, _ = cand[b]
        if ia == ib or ja == jb:
            continue
        seen.add((a, b))
        dl = math.hypot(pl[ia][0] - pl[ib][0], pl[ia][1] - pl[ib][1])
        dr = math.hypot(pr[ja][0] - pr[jb][0], pr[ja][1] - pr[jb][1])
        quadratic.append(((ia, ib), (ja, jb), abs(dl - dr) - 0.1))
    return cand, quadratic


def _name(i: int) -> str:
    return "s" if i == NO_ASSIGNMENT else str(i)


def ilp(linear, quadratic) -> Model:
    m = Model()
    left: List[List[int]] = []
    right: List[List[int]] = []
    for i, j, _ in linear:
        while len(left) <= i:
            left.append([])
        left[i].append(j)
        while len(right) <= j:
            right.append([])
        right[j].append(i)
    left = [sorted(set(labels + [NO_ASSIGNMENT])) for labels in left]
    right = [sorted(set(labels + [NO_ASSIGNMENT])) for labels in right]

    assign: Dict[Tuple[int, int], int] = {}
    for i, labels in enumerate(left):
        vs = []
        for j in labels:
            assign[(i, j)] = m.add_var(f"x_{_name(i)}_{_name(j)}")
            vs.append(assign[(i, j)])
        m.add_row([1] * len(vs), vs, "=", 1, f"simplex_l_{i}")
    for j, labels in enumerate(right):
        vs = []
        for i in labels:
            if i == NO_ASSIGNMENT:
                assign[(i, j)] = m.add_var(f"x_{_name(i)}_{_name(j)}")
            vs.append(assign[(i, j)])
        m.add_row([1] * len(vs), vs, "=", 1, f"simplex_r_{j}")
    for i, j, c in linear:
        m.objective[assign[(i, j)]] += c

    quad: Dict[Tuple[int, int, int, int], int] = {}

    def qvar(i, j) -> int:
        (i0, i1), (j0, j1) = i, j
        if i0 > i1:
            i0, i1, j0, j1 = i1, i0, j1, j0
        key = (i0, i1, j0, j1)
        if key not in quad:
            quad[key] = m.add_var(f"q_{_name(i0)}_{_name(i1)}_{_name(j0)}_{_name(j1)}")
        return quad[key]

    left_quad, right_quad = set(), set()
    for i, j, c in quadratic:
        if i[0] == i[1] or j[0] == j[1]:
            continue
        m.objective[qvar(i, j)] += c
        left_quad.add((min(i), max(i)))
        right_quad.add((min(j), max(j)))

    if 10 * len(left_quad) <= len(right_quad):
        sides = (True, False)
    elif 10 * len(right_quad) <= len(left_quad):
        sides = (False, True)
    else:
        sides = (True, True)

    def admissible(a: int, b: int) -> bool:
        return a != b or a == NO_ASSIGNMENT

    def marginals(pairs, labels, key, tag):
        for a0, a1 in sorted(pairs):
            for b0 in labels[a0]:
                vs, cs = [assign[key(a0, b0)]], [-1]
                for b1 in labels[a1]:
                    if admissible(b0, b1):
                        vs.append(qvar(*_pair(tag, a0, a1, b0, b1)))
                        cs.append(1)
                m.add_row(cs, vs, "=", 0, f"quadratic_{tag}_{a0}_{a1}_{b0}")
            for b1 in labels[a1]:
                vs, cs = [assign[key(a1, b1)]], [-1]
                for b0 in labels[a0]:
                    if admissible(b0, b1):
                        vs.append(qvar(*_pair(tag, a0, a1, b0, b1)))
                        cs.append(1)
                other = "r" if tag == "l" else "l"
                m.add_row(cs, vs, "=", 0, f"quadratic_{tag}_{a0}_{a1}_{other}{b1}")

    if sides[0]:
        marginals(left_quad, left, lambda i, j: (i, j), "l")
    if sides[1]:
        marginals(right_quad, right, lambda j, i: (i, j), "r")
    return m


def _pair(tag, a0, a1, b0, b1):
    """The (left pair, right pair) of a product variable from one side's view."""
    if tag == "l":
        return (a0, a1), (b0, b1)
    return (b0, b1), (a0, a1)


def make(params: dict, seed: int) -> Model:
    lin, quad = instance(params["n_left"], params["n_right"], seed,
                         params["candidates"], params["nr_quadratic"])
    return ilp(lin, quad)
