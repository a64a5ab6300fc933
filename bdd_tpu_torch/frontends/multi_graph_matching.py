"""Multi-graph matching frontend.

Format (ref: src/specialized_solvers/multi_graph_matching_input.cpp): blocks
``gm <p> <q>`` (p < q), each followed by a Torresani-et-al '.dd' body. The ILP
concatenates every pairwise matching's ILP (variables prefixed
``mgm_<p>_<q>_``) and adds cycle-consistency constraints

    sum_k'' x_ik(x_i, l) * x_jk(x_j, l)  -  x_ij(x_i, x_j)  <=  0

with quadratic monomials over the transit graph k (multi_graph_matching_input
.cpp:161-230); the monomials are linearized by the BDD preprocessor.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from bdd_tpu_torch.frontends.graph_matching import (
    NO_ASSIGNMENT,
    GraphMatchingInstance,
    construct_graph_matching_ilp,
    parse_dd_string,
)
from bdd_tpu_torch.ilp.model import ILPInput, Ineq


def parse_mgm_string(text: str) -> Dict[Tuple[int, int], GraphMatchingInstance]:
    blocks: Dict[Tuple[int, int], GraphMatchingInstance] = {}
    cur_key = None
    cur_lines: List[str] = []
    for raw in text.split("\n") + ["gm -1 -1"]:  # sentinel flushes last block
        line = raw.strip()
        if line.startswith("gm "):
            if cur_key is not None:
                blocks[cur_key] = parse_dd_string("\n".join(cur_lines))
            parts = line.split()
            p, q = int(parts[1]), int(parts[2])
            cur_key = (p, q) if p >= 0 else None
            cur_lines = []
        else:
            cur_lines.append(raw)
    return blocks


def parse_mgm_file(path: str) -> Dict[Tuple[int, int], GraphMatchingInstance]:
    with open(path) as fh:
        return parse_mgm_string(fh.read())


def construct_multi_graph_matching_ilp(
    blocks: Dict[Tuple[int, int], GraphMatchingInstance]
) -> ILPInput:
    if not blocks:
        raise ValueError(
            "no 'gm <p> <q>' blocks found — not a multi-graph-matching file")
    nr_graphs = max(max(k) for k in blocks) + 1
    ilp = ILPInput()
    linear_maps: Dict[Tuple[int, int], Dict[Tuple[int, int], int]] = {}

    for (p, q) in sorted(blocks):
        assert p < q, "gm blocks must be given with p < q"
        gm_ilp, lin_map, _ = construct_graph_matching_ilp(blocks[(p, q)])
        offset = ilp.nr_variables()
        for v in range(gm_ilp.nr_variables()):
            nv = ilp.add_new_variable(f"mgm_{p}_{q}_{gm_ilp.get_var_name(v)}")
            ilp.objective_[nv] = gm_ilp.objective_[v]
        for c in gm_ilp.constraints():
            ilp.add_constraint(
                c.coefficients,
                [tuple(offset + v for v in m) for m in c.monomials],
                c.ineq,
                c.rhs,
                f"mgm_{p}_{q}_{c.name}",
            )
        linear_maps[(p, q)] = {k: v + offset for k, v in lin_map.items()}

    # per ordered pair (p -> r): label-of-p -> {label-of-r -> var}; built
    # ONCE (the previous per-assignment rebuild scanned every pair entry for
    # every (x_i, x_j, k) — hundreds of millions of dict ops at scale)
    by_label: Dict[Tuple[int, int], Dict[int, Dict[int, int]]] = {}
    for (p, q), lm in linear_maps.items():
        fwd: Dict[int, Dict[int, int]] = {}
        rev: Dict[int, Dict[int, int]] = {}
        for (a, b), var in lm.items():
            if a != NO_ASSIGNMENT:
                fwd.setdefault(a, {})[b] = var
            if b != NO_ASSIGNMENT:
                rev.setdefault(b, {})[a] = var
        by_label[(p, q)] = fwd
        by_label[(q, p)] = rev

    # cycle consistency: X_ij * X_jk <= X_ik (quadratic monomials).
    # Sparse instances may omit pairwise blocks — cycles touching a missing
    # pair are simply not constrained (as with the reference's per-pair
    # construction over present pairs only).
    for i in range(nr_graphs):
        for j in range(i + 1, nr_graphs):
            ij_vars = linear_maps.get((i, j))
            if ij_vars is None:
                continue
            for (x_i, x_j), ij_var in sorted(ij_vars.items()):
                if x_i == NO_ASSIGNMENT or x_j == NO_ASSIGNMENT:
                    continue
                for k in range(nr_graphs):
                    if k == i or k == j:
                        continue
                    if (min(j, k), max(j, k)) not in linear_maps or (
                        min(i, k), max(i, k)
                    ) not in linear_maps:
                        continue
                    a_jk = by_label[(j, k)].get(x_j, {})
                    a_ik = by_label[(i, k)].get(x_i, {})
                    monomials = []
                    for x_k, ik_var in sorted(a_ik.items()):
                        if x_k in a_jk and x_k != NO_ASSIGNMENT:
                            monomials.append((ik_var, a_jk[x_k]))
                    if monomials:
                        ilp.add_constraint(
                            [1] * len(monomials) + [-1],
                            monomials + [(ij_var,)],
                            Ineq.LEQ,
                            0,
                        )
    return ilp
