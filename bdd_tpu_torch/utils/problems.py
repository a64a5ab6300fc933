"""Synthetic structured-problem generators (benchmark + test instances).

Mirrors the reference's benchmark families (SURVEY.md §6): binary/multilabel
MRFs (cell tracking / color-seg style), assignment/graph-matching, set cover,
and independent set (DOGE MIS protocol, DOGE/data/generate_independent_set_inst.py).
All generators return an ILPInput directly (no file round-trip).
"""
from __future__ import annotations

import random
from typing import Optional

from bdd_tpu_torch.ilp.model import ILPInput, Ineq


def grid_mrf(
    rows: int,
    cols: int,
    labels: int,
    seed: int = 0,
    potts: Optional[float] = None,
) -> ILPInput:
    """Pairwise MRF on a grid as local-polytope ILP: unary simplexes, pairwise
    simplexes and marginalization constraints (the reference's MRF frontend,
    src/specialized_solvers/mrf_input.cpp:64-160)."""
    rng = random.Random(seed)
    ilp = ILPInput()

    def u(i, j, a):
        return f"mu_{i}_{j}_{a}"

    def p(i, j, i2, j2, a, b):
        return f"mu_{i}_{j}_{i2}_{j2}_{a}_{b}"

    edges = []
    for i in range(rows):
        for j in range(cols):
            for a in range(labels):
                ilp.add_to_objective(rng.uniform(-1.0, 1.0), u(i, j, a))
            if i + 1 < rows:
                edges.append(((i, j), (i + 1, j)))
            if j + 1 < cols:
                edges.append(((i, j), (i, j + 1)))
    for (i, j), (i2, j2) in edges:
        for a in range(labels):
            for b in range(labels):
                if potts is not None:
                    c = 0.0 if a == b else potts
                else:
                    c = rng.uniform(-1.0, 1.0)
                ilp.add_to_objective(c, p(i, j, i2, j2, a, b))

    # unary simplex
    for i in range(rows):
        for j in range(cols):
            vs = [ilp.get_var_index(u(i, j, a)) for a in range(labels)]
            ilp.add_linear_constraint([1] * labels, vs, Ineq.EQ, 1)
    # pairwise simplex + marginalization
    for (i, j), (i2, j2) in edges:
        pvars = [
            ilp.get_var_index(p(i, j, i2, j2, a, b))
            for a in range(labels)
            for b in range(labels)
        ]
        ilp.add_linear_constraint([1] * len(pvars), pvars, Ineq.EQ, 1)
        for a in range(labels):
            vs = [ilp.get_var_index(u(i, j, a))] + [
                ilp.get_var_index(p(i, j, i2, j2, a, b)) for b in range(labels)
            ]
            ilp.add_linear_constraint([1] + [-1] * labels, vs, Ineq.EQ, 0)
        for b in range(labels):
            vs = [ilp.get_var_index(u(i2, j2, b))] + [
                ilp.get_var_index(p(i, j, i2, j2, a, b)) for a in range(labels)
            ]
            ilp.add_linear_constraint([1] + [-1] * labels, vs, Ineq.EQ, 0)
    return ilp


def assignment(n: int, seed: int = 0) -> ILPInput:
    """n x n assignment problem (graph matching without quadratic terms)."""
    rng = random.Random(seed)
    ilp = ILPInput()
    for i in range(n):
        for j in range(n):
            ilp.add_to_objective(rng.uniform(-10.0, 10.0), f"x_{i}_{j}")
    for i in range(n):
        vs = [ilp.get_var_index(f"x_{i}_{j}") for j in range(n)]
        ilp.add_linear_constraint([1] * n, vs, Ineq.EQ, 1)
    for j in range(n):
        vs = [ilp.get_var_index(f"x_{i}_{j}") for i in range(n)]
        ilp.add_linear_constraint([1] * n, vs, Ineq.EQ, 1)
    return ilp


def set_cover(
    nr_elements: int, nr_sets: int, density: float = 0.2, seed: int = 0
) -> ILPInput:
    rng = random.Random(seed)
    ilp = ILPInput()
    members = [[] for _ in range(nr_elements)]
    for s in range(nr_sets):
        ilp.add_to_objective(rng.uniform(0.5, 5.0), f"s_{s}")
        for e in range(nr_elements):
            if rng.random() < density:
                members[e].append(s)
    for e, ms in enumerate(members):
        if not ms:
            ms.append(rng.randrange(nr_sets))
        vs = [ilp.get_var_index(f"s_{s}") for s in ms]
        ilp.add_linear_constraint([1] * len(vs), vs, Ineq.GEQ, 1)
    return ilp


def independent_set(
    nr_nodes: int, edge_prob: float = 0.25, seed: int = 0
) -> ILPInput:
    """Maximum-weight independent set on an Erdos-Renyi graph
    (DOGE MIS protocol, DOGE/data/generate_independent_set_inst.py)."""
    rng = random.Random(seed)
    ilp = ILPInput()
    for v in range(nr_nodes):
        ilp.add_to_objective(-rng.uniform(0.0, 1.0), f"x_{v}")
    for a in range(nr_nodes):
        for b in range(a + 1, nr_nodes):
            if rng.random() < edge_prob:
                ilp.add_linear_constraint(
                    [1, 1],
                    [ilp.get_var_index(f"x_{a}"), ilp.get_var_index(f"x_{b}")],
                    Ineq.LEQ,
                    1,
                )
    return ilp


def quadratic_assignment(n: int, seed: int = 0, density: float = 0.5) -> ILPInput:
    """Small QAPLIB-style instance: assignment constraints + quadratic
    objective terms linearized through product variables (exercises the
    nonlinear-monomial path, ref: specialized_solvers graph matching)."""
    rng = random.Random(seed)
    ilp = assignment(n, seed)
    terms = 0
    for i in range(n):
        for j in range(n):
            for k in range(i + 1, n):
                for l in range(n):
                    if l == j or rng.random() > density:
                        continue
                    c = rng.uniform(-1.0, 1.0)
                    vi = ilp.get_var_index(f"x_{i}_{j}")
                    vk = ilp.get_var_index(f"x_{k}_{l}")
                    # quadratic objective term c * x_ij * x_kl via an explicit
                    # product variable (Fortet linearization)
                    y = ilp.get_or_create_variable(f"y_{i}_{j}_{k}_{l}")
                    ilp.add_to_objective(c, y)
                    ilp.add_linear_constraint([1, -1], [y, vi], Ineq.LEQ, 0)
                    ilp.add_linear_constraint([1, -1], [y, vk], Ineq.LEQ, 0)
                    ilp.add_linear_constraint(
                        [1, -1, -1], [y, vi, vk], Ineq.GEQ, -1
                    )
                    terms += 1
    return ilp


def graph_matching(n_left: int, n_right: int, seed: int = 0,
                   candidates: int = 5, nr_quadratic: int = 0):
    """Synthetic geometric graph-matching instance in the frontends'
    GraphMatchingInstance form: each left point gets a few candidate right
    points with distance costs; optional quadratic terms reward preserving
    pairwise distances (the benchmark family of hotel/house/worms,
    SURVEY.md §6)."""
    import math as _math

    rng = random.Random(seed)
    from bdd_tpu_torch.frontends.graph_matching import GraphMatchingInstance

    pl = [(rng.random(), rng.random()) for _ in range(n_left)]
    pts_right = [(rng.random(), rng.random()) for _ in range(n_right)]
    inst = GraphMatchingInstance()
    cand = []
    for i, (x, y) in enumerate(pl):
        dists = sorted(
            (( _math.hypot(x - a, y - b), j) for j, (a, b) in enumerate(pts_right))
        )[:candidates]
        for d, j in dists:
            cand.append((i, j, d - 0.5))
    inst.linear = cand
    ids = list(range(len(cand)))
    seen_pairs = set()
    attempts = 0
    # sample WITHOUT duplicates (a duplicated (i,j) pair would double its
    # cost via the shared product variable) and retry inadmissible draws so
    # the requested term count is actually reached when possible
    while len(inst.quadratic) < nr_quadratic and attempts < 20 * max(
        nr_quadratic, 1
    ):
        attempts += 1
        if len(ids) < 2:
            break
        a, b = rng.sample(ids, 2)
        if (a, b) in seen_pairs or (b, a) in seen_pairs:
            continue
        ia, ja, _c = cand[a]
        ib, jb, _c2 = cand[b]
        if ia == ib or ja == jb:
            continue
        seen_pairs.add((a, b))
        dl = _math.hypot(pl[ia][0] - pl[ib][0], pl[ia][1] - pl[ib][1])
        dr = _math.hypot(pts_right[ja][0] - pts_right[jb][0], pts_right[ja][1] - pts_right[jb][1])
        inst.quadratic.append(((ia, ib), (ja, jb), abs(dl - dr) - 0.1))
    return inst


def cell_tracking(
    nr_frames: int,
    cells_per_frame: int,
    nr_transitions: int = 3,
    division_prob: float = 0.3,
    conflict_prob: float = 0.3,
    seed: int = 0,
) -> ILPInput:
    """Cell-tracking ILP in the drosophila-benchmark style (the reference's
    CT family: regression instance `drosophila.lp`, DOGE config_ct.py):
    detection hypotheses per frame, transition/division hypotheses between
    consecutive frames, appearance/disappearance slack, flow-conservation
    equalities per detection and at-most-one exclusion constraints between
    spatially conflicting detections.

    Variables (frame t, detection i):
      d_{t,i}   detection active (negative cost: evidence reward)
      a_{t,i}   appearance, e_{t,i} disappearance (small positive cost)
      m_{t,i,j} transition to detection j of frame t+1 (distance-like cost)
      s_{t,i,j,k} division into detections j<k of frame t+1

    Constraints:
      incoming:  d_{t,i} = a_{t,i} + sum_j m_{t-1,j,i} + sum div hitting i
      outgoing:  d_{t,i} = e_{t,i} + sum_j m_{t,i,j} + sum_s s_{t,i,*}
      conflict:  sum_{i in C} d_{t,i} <= 1 for sampled conflict pairs
    """
    rng = random.Random(seed)
    ilp = ILPInput()
    F, N = nr_frames, cells_per_frame

    def det(t, i):
        return f"d_{t}_{i}"

    # detections with evidence reward
    for t in range(F):
        for i in range(N):
            ilp.add_to_objective(-rng.uniform(0.5, 2.0), det(t, i))
    # transition / division candidates between consecutive frames
    out_terms = {(t, i): [] for t in range(F) for i in range(N)}
    in_terms = {(t, i): [] for t in range(F) for i in range(N)}
    for t in range(F - 1):
        for i in range(N):
            cands = rng.sample(range(N), min(nr_transitions, N))
            for j in cands:
                v = f"m_{t}_{i}_{j}"
                ilp.add_to_objective(rng.uniform(0.1, 1.5), v)
                out_terms[(t, i)].append(v)
                in_terms[(t + 1, j)].append(v)
            if len(cands) >= 2 and rng.random() < division_prob:
                j, k = sorted(rng.sample(cands, 2))
                v = f"s_{t}_{i}_{j}_{k}"
                ilp.add_to_objective(rng.uniform(0.5, 2.5), v)
                out_terms[(t, i)].append(v)
                in_terms[(t + 1, j)].append(v)
                in_terms[(t + 1, k)].append(v)
    # flow conservation with appearance/disappearance slack
    for t in range(F):
        for i in range(N):
            app = f"a_{t}_{i}"
            dis = f"e_{t}_{i}"
            ilp.add_to_objective(0.2 if t > 0 else 0.01, app)
            ilp.add_to_objective(0.2 if t < F - 1 else 0.01, dis)
            inc = [app] + in_terms[(t, i)]
            out = [dis] + out_terms[(t, i)]
            dv = ilp.get_var_index(det(t, i))
            ilp.add_linear_constraint(
                [1] * len(inc) + [-1],
                [ilp.get_var_index(v) for v in inc] + [dv],
                Ineq.EQ,
                0,
            )
            ilp.add_linear_constraint(
                [1] * len(out) + [-1],
                [ilp.get_var_index(v) for v in out] + [dv],
                Ineq.EQ,
                0,
            )
    # spatial exclusion between sampled detection pairs
    for t in range(F):
        for i in range(N):
            for j in range(i + 1, N):
                if rng.random() < conflict_prob:
                    ilp.add_linear_constraint(
                        [1, 1],
                        [
                            ilp.get_var_index(det(t, i)),
                            ilp.get_var_index(det(t, j)),
                        ],
                        Ineq.LEQ,
                        1,
                    )
    return ilp
