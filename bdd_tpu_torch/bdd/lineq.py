"""Linear inequality → reduced ordered BDD.

Layered DP over remaining right-hand-side budget (Behle 2007): the reference
builds the BDD top-down with interval-keyed AVL dedup per level
(src/bdd_conversion/lineq_bdd.cpp:7-171, normal form lineq_bdd.h:69-90).
We achieve the identical canonical result with a two-pass scheme that fits
arrays better: (1) top-down reachable-budget enumeration with TOP/BOT clamping,
(2) bottom-up merging of budgets with equal (lo, hi) children — layered DFA
minimization, which for this layered structure coincides with the interval
dedup and yields the fully-reduced OBDD.

Normal form: >= is negated into <=; negative coefficients are removed by the
substitution x -> 1-x (recorded as per-level flips, applied by swapping lo/hi
arcs on emission — ref: lineq_bdd.cpp:79-88); coefficients divided by their gcd.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

from bdd_tpu_torch.bdd.collection import BOT, TOP, BddCollection
from bdd_tpu_torch.ilp.model import Constraint, Ineq

# Markers for trivial outcomes
ALWAYS_TRUE = "always_true"
ALWAYS_FALSE = "always_false"

_TOPS = "T"  # internal clamp marker
_BOTS = "B"


def _clamp_leq(b: int, max_suffix: int) -> Union[int, str]:
    if b < 0:
        return _BOTS
    if b >= max_suffix:
        return _TOPS
    return b


def _clamp_eq(b: int, max_suffix: int, is_last: bool) -> Union[int, str]:
    if b < 0 or b > max_suffix:
        return _BOTS
    if is_last:  # max_suffix == 0 here, so b == 0
        return _TOPS
    return b


def build_inequality_bdd_nodes(
    coefficients: Sequence[int],
    ineq: Ineq,
    rhs: int,
) -> Union[str, List[Tuple[int, int, int]]]:
    """Build the reduced OBDD of  sum_i c_i x_i  (ineq)  rhs  over levels
    0..n-1. Returns ALWAYS_TRUE / ALWAYS_FALSE for trivial constraints, else a
    local node list (level, lo, hi) in topological root-first order suitable
    for :meth:`BddCollection.add_bdd` (with `level` in place of the variable).
    """
    coeffs = list(coefficients)
    n = len(coeffs)
    if ineq == Ineq.GEQ:
        coeffs = [-c for c in coeffs]
        rhs = -rhs
        ineq = Ineq.LEQ

    # flip negative coefficients: c*x with c<0 -> (-c)*(1-x) - (-c)… i.e.
    # x := 1-x, coefficient -c > 0, rhs -= c
    flip = [c < 0 for c in coeffs]
    rhs -= sum(c for c in coeffs if c < 0)
    coeffs = [abs(c) for c in coeffs]

    if any(c == 0 for c in coeffs):
        raise ValueError("zero coefficient in constraint (normalize first)")

    # gcd reduction
    if n > 0:
        g = 0
        for c in coeffs:
            g = math.gcd(g, c)
        if g > 1:
            if ineq == Ineq.LEQ:
                # exact integer floor: float division loses precision past
                # 2^53 and would change the feasible set
                rhs = int(rhs) // g if rhs == int(rhs) else math.floor(rhs / g)
            else:
                if rhs % g != 0:
                    return ALWAYS_FALSE
                rhs //= g
            coeffs = [c // g for c in coeffs]

    max_suffix = [0] * (n + 1)
    for i in range(n - 1, -1, -1):
        max_suffix[i] = max_suffix[i + 1] + coeffs[i]

    def clamp(i: int, b: int) -> Union[int, str]:
        if ineq == Ineq.LEQ:
            return _clamp_leq(b, max_suffix[i])
        return _clamp_eq(b, max_suffix[i], i == n)

    s0 = clamp(0, rhs)
    if s0 == _TOPS:
        return ALWAYS_TRUE
    if s0 == _BOTS:
        return ALWAYS_FALSE

    # pass 1: reachable budgets per level
    levels: List[List[int]] = [[] for _ in range(n + 1)]
    levels[0] = [s0]
    seen: List[set] = [set() for _ in range(n + 1)]
    seen[0].add(s0)
    for i in range(n):
        nxt = seen[i + 1]
        ci = coeffs[i]
        for b in levels[i]:
            for bb in (b, b - ci):
                c = clamp(i + 1, bb)
                if not isinstance(c, str) and c not in nxt:
                    nxt.add(c)
                    levels[i + 1].append(c)

    # pass 2: bottom-up merge by (lo, hi) signature
    nodes: List[Tuple[int, int, int]] = []  # (level, lo_id, hi_id) ids into nodes
    node_of: List[Dict[int, int]] = [dict() for _ in range(n + 1)]

    def resolve(i: int, b: int) -> int:
        c = clamp(i, b)
        if c == _TOPS:
            return TOP
        if c == _BOTS:
            return BOT
        return node_of[i][c]

    for i in range(n - 1, -1, -1):
        sig: Dict[Tuple[int, int], int] = {}
        ci = coeffs[i]
        for b in sorted(seen[i]):
            lo = resolve(i + 1, b)
            hi = resolve(i + 1, b - ci)
            if lo == hi:
                node_of[i][b] = lo
                continue
            key = (lo, hi)
            if key not in sig:
                nodes.append((i, lo, hi))
                sig[key] = len(nodes) - 1
            node_of[i][b] = sig[key]

    root = node_of[0][s0]
    if root == TOP:
        return ALWAYS_TRUE
    if root == BOT:
        return ALWAYS_FALSE

    # apply flips (swap lo/hi on flipped levels)
    if any(flip):
        nodes = [
            (lvl, hi, lo) if flip[lvl] else (lvl, lo, hi) for (lvl, lo, hi) in nodes
        ]

    # topological re-order: nodes were created bottom-up; sort by level with
    # root first. Node ids are positions in `nodes`; build mapping.
    order = sorted(range(len(nodes)), key=lambda k: (nodes[k][0], k))
    # ensure root is the unique minimal-level node first
    if order[0] != root:
        order.remove(root)
        order.insert(0, root)
    new_id = {k: j for j, k in enumerate(order)}
    out = []
    for k in order:
        lvl, lo, hi = nodes[k]
        out.append(
            (
                lvl,
                lo if lo < 0 else new_id[lo],
                hi if hi < 0 else new_id[hi],
            )
        )
    return out


def bdd_from_inequality(
    constraint: Constraint,
    collection: BddCollection,
    var_order: Optional[Sequence[int]] = None,
) -> Union[str, int]:
    """Convert a *linear* constraint into a BDD appended to ``collection``.

    Variables appear in ascending index order (the constraint must be
    normalized). Returns the new bdd number, or ALWAYS_TRUE/ALWAYS_FALSE.
    """
    assert constraint.is_linear(), "nonlinear constraints need monomial expansion"
    variables = [m[0] for m in constraint.monomials]
    assert all(
        variables[i] < variables[i + 1] for i in range(len(variables) - 1)
    ), "constraint must be normalized (strictly ascending, no duplicates)"
    nodes = build_inequality_bdd_nodes(
        constraint.coefficients, constraint.ineq, constraint.rhs
    )
    if isinstance(nodes, str):
        return nodes
    mapped = [(variables[lvl], lo, hi) for (lvl, lo, hi) in nodes]
    return collection.add_bdd(mapped)
