"""Graph matching frontend (Torresani et al. '.dd' dual-decomposition format).

Format (ref: include/specialized_solvers/graph_matching_torresani_et_al_grammar.h):
    p <N0> <N1> <A> <E>
    a <a> <i> <j> {cost}      assignment a: left point i -> right point j
    e <a> <b> {cost}          quadratic term between assignments a and b
    c ... / i0 / i1 / n0 / n1 lines are comments/ignored

ILP construction (exact port of construct_graph_matching_ILP,
src/specialized_solvers/graph_matching_input.cpp:13-260): per-left-point and
per-right-point simplexes including a 'no assignment' slack, quadratic product
variables with marginalization constraints linking them to the assignments on
the smaller of the two sides (both when comparable).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from bdd_tpu_torch.ilp.model import ILPInput, Ineq

NO_ASSIGNMENT = -1  # the reference's slack label (size_t max)


@dataclass
class GraphMatchingInstance:
    # assignment id -> (left, right, cost)
    linear: List[Tuple[int, int, float]] = field(default_factory=list)
    # ((i0,i1),(j0,j1), cost) pairs of left points and their right labels
    quadratic: List[Tuple[Tuple[int, int], Tuple[int, int], float]] = field(
        default_factory=list
    )


def parse_dd_string(text: str) -> GraphMatchingInstance:
    inst = GraphMatchingInstance()
    assignments: Dict[int, Tuple[int, int, float]] = {}
    for raw in text.split("\n"):
        line = raw.strip()
        if not line or line[0] in "c#":
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "p":
            continue
        if tag == "a":
            a, i, j, cost = int(parts[1]), int(parts[2]), int(parts[3]), float(parts[4])
            assignments[a] = (i, j, cost)
        elif tag == "e":
            a, b, cost = int(parts[1]), int(parts[2]), float(parts[3])
            ia, ja, _ = assignments[a]
            ib, jb, _ = assignments[b]
            inst.quadratic.append(((ia, ib), (ja, jb), cost))
        elif tag in ("i0", "i1", "n0", "n1"):
            continue
        else:
            raise ValueError(f"unknown line: {raw!r}")
    inst.linear = [assignments[a] for a in sorted(assignments)]
    return inst


def parse_dd_file(path: str) -> GraphMatchingInstance:
    with open(path) as fh:
        return parse_dd_string(fh.read())


def construct_graph_matching_ilp(
    inst: GraphMatchingInstance,
) -> Tuple[ILPInput, Dict[Tuple[int, int], int], Dict[Tuple[int, int, int, int], int]]:
    """Returns (ilp, linear var map {(i,j) -> var}, quadratic var map)."""
    ilp = ILPInput()

    left: List[List[int]] = []
    right: List[List[int]] = []
    for (i, j, c) in inst.linear:
        while len(left) <= i:
            left.append([])
        left[i].append(j)
        while len(right) <= j:
            right.append([])
        right[j].append(i)
    for l in left:
        l.append(NO_ASSIGNMENT)
    for r in right:
        r.append(NO_ASSIGNMENT)
    left = [sorted(set(l)) for l in left]
    right = [sorted(set(r)) for r in right]

    def vname(i: int, j: int) -> str:
        si = "s" if i == NO_ASSIGNMENT else str(i)
        sj = "s" if j == NO_ASSIGNMENT else str(j)
        return f"x_{si}_{sj}"

    assignment_map: Dict[Tuple[int, int], int] = {}
    # left simplexes
    for i, labels in enumerate(left):
        vs = []
        for j in labels:
            v = ilp.add_new_variable(vname(i, j))
            assignment_map[(i, j)] = v
            vs.append(v)
        ilp.add_linear_constraint([1] * len(vs), vs, Ineq.EQ, 1, f"simplex_l_{i}")
    # right simplexes (slack vars created here)
    for j, labels in enumerate(right):
        vs = []
        for i in labels:
            if i == NO_ASSIGNMENT:
                v = ilp.add_new_variable(vname(NO_ASSIGNMENT, j))
                assignment_map[(NO_ASSIGNMENT, j)] = v
            else:
                v = assignment_map[(i, j)]
            vs.append(v)
        ilp.add_linear_constraint([1] * len(vs), vs, Ineq.EQ, 1, f"simplex_r_{j}")

    # linear costs
    for (i, j, c) in inst.linear:
        ilp.add_to_objective(c, assignment_map[(i, j)])

    # quadratic variables
    quadratic_map: Dict[Tuple[int, int, int, int], int] = {}

    def get_quadratic_var(i: Tuple[int, int], j: Tuple[int, int]) -> int:
        (i0, i1), (j0, j1) = i, j
        if i0 > i1:
            i0, i1 = i1, i0
            j0, j1 = j1, j0
        key = (i0, i1, j0, j1)
        v = quadratic_map.get(key)
        if v is None:
            def s(x):
                return "s" if x == NO_ASSIGNMENT else str(x)

            v = ilp.add_new_variable(f"q_{s(i0)}_{s(i1)}_{s(j0)}_{s(j1)}")
            quadratic_map[key] = v
        return v

    left_quad: Dict[Tuple[int, int], bool] = {}
    right_quad: Dict[Tuple[int, int], bool] = {}
    for (i, j, c) in inst.quadratic:
        if i[0] == i[1] or j[0] == j[1]:
            continue  # inadmissible (ref: graph_matching_input.cpp:133-134)
        v = get_quadratic_var(i, j)
        ilp.add_to_objective(c, v)
        left_quad[(min(i), max(i))] = True
        right_quad[(min(j), max(j))] = True

    # choose which side(s) get the marginalization constraints
    if 10 * len(left_quad) <= len(right_quad):
        build_left, build_right = True, False
    elif 10 * len(right_quad) <= len(left_quad):
        build_left, build_right = False, True
    else:
        build_left, build_right = True, True

    def admissible(j0: int, j1: int) -> bool:
        return j0 != j1 or j0 == NO_ASSIGNMENT

    if build_left:
        for (i0, i1) in sorted(left_quad):
            for j0 in left[i0]:
                vs = [assignment_map[(i0, j0)]]
                coeffs = [-1]
                for j1 in left[i1]:
                    if admissible(j0, j1):
                        vs.append(get_quadratic_var((i0, i1), (j0, j1)))
                        coeffs.append(1)
                ilp.add_linear_constraint(
                    coeffs, vs, Ineq.EQ, 0, f"quadratic_l_{i0}_{i1}_{j0}"
                )
            for j1 in left[i1]:
                vs = [assignment_map[(i1, j1)]]
                coeffs = [-1]
                for j0 in left[i0]:
                    if admissible(j0, j1):
                        vs.append(get_quadratic_var((i0, i1), (j0, j1)))
                        coeffs.append(1)
                ilp.add_linear_constraint(
                    coeffs, vs, Ineq.EQ, 0, f"quadratic_l_{i0}_{i1}_r{j1}"
                )
    if build_right:
        for (j0, j1) in sorted(right_quad):
            for i0 in right[j0]:
                vs = [assignment_map[(i0, j0)]]
                coeffs = [-1]
                for i1 in right[j1]:
                    if admissible(i0, i1):
                        vs.append(get_quadratic_var((i0, i1), (j0, j1)))
                        coeffs.append(1)
                ilp.add_linear_constraint(
                    coeffs, vs, Ineq.EQ, 0, f"quadratic_r_{j0}_{j1}_{i0}"
                )
            for i1 in right[j1]:
                vs = [assignment_map[(i1, j1)]]
                coeffs = [-1]
                for i0 in right[j0]:
                    if admissible(i0, i1):
                        vs.append(get_quadratic_var((i0, i1), (j0, j1)))
                        coeffs.append(1)
                ilp.add_linear_constraint(
                    coeffs, vs, Ineq.EQ, 0, f"quadratic_r_{j0}_{j1}_l{i1}"
                )
    return ilp, assignment_map, quadratic_map


def parse_graph_matching_file(path: str) -> ILPInput:
    return construct_graph_matching_ilp(parse_dd_file(path))[0]


def parse_graph_matching_string(text: str) -> ILPInput:
    return construct_graph_matching_ilp(parse_dd_string(text))[0]
