"""UAI MRF frontend.

Parses the UAI inference format (optional MARKOV header; #vars, label counts,
#cliques, clique scopes, then one function table per clique — ref grammar:
src/specialized_solvers/mrf_uai_parser.cpp) and converts the MRF into a
local-polytope 0-1 ILP: unary + pairwise simplex constraints and
marginalization couplings (exact port of mrf_input::convert_to_ilp,
src/specialized_solvers/mrf_input.cpp:64-160).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from bdd_tpu_torch.ilp.model import ILPInput, Ineq


class MrfInput:
    def __init__(self) -> None:
        self.nr_labels: List[int] = []
        self.unaries: Dict[int, List[float]] = {}
        # pairwise: (i, j) -> row-major table of size labels(i) x labels(j)
        self.pairwise: List[Tuple[int, int, List[float]]] = []

    def nr_variables(self) -> int:
        return len(self.nr_labels)

    def convert_to_ilp(self) -> ILPInput:
        ilp = ILPInput()
        unary_offsets = []
        for i, nl in enumerate(self.nr_labels):
            unary_offsets.append(ilp.nr_variables())
            u = self.unaries.get(i, [0.0] * nl)
            for l in range(nl):
                v = ilp.add_new_variable(f"x_{i}_{l}")
                ilp.add_to_objective(u[l], v)
        pairwise_offsets = []
        for (i, j, table) in self.pairwise:
            pairwise_offsets.append(ilp.nr_variables())
            for li in range(self.nr_labels[i]):
                for lj in range(self.nr_labels[j]):
                    v = ilp.add_new_variable(f"x_{i}_{j}_{li}_{lj}")
                    ilp.add_to_objective(table[li * self.nr_labels[j] + lj], v)
        # unary simplexes
        for i, nl in enumerate(self.nr_labels):
            ilp.add_linear_constraint(
                [1] * nl, range(unary_offsets[i], unary_offsets[i] + nl), Ineq.EQ, 1
            )
        # pairwise simplexes
        for p, (i, j, _) in enumerate(self.pairwise):
            n = self.nr_labels[i] * self.nr_labels[j]
            ilp.add_linear_constraint(
                [1] * n, range(pairwise_offsets[p], pairwise_offsets[p] + n), Ineq.EQ, 1
            )
        # marginalization constraints
        for p, (i, j, _) in enumerate(self.pairwise):
            nli, nlj = self.nr_labels[i], self.nr_labels[j]
            for li in range(nli):
                vs = [unary_offsets[i] + li] + [
                    pairwise_offsets[p] + li * nlj + lj for lj in range(nlj)
                ]
                ilp.add_linear_constraint([-1] + [1] * nlj, vs, Ineq.EQ, 0)
            for lj in range(nlj):
                vs = [unary_offsets[j] + lj] + [
                    pairwise_offsets[p] + li * nlj + lj for li in range(nli)
                ]
                ilp.add_linear_constraint([-1] + [1] * nli, vs, Ineq.EQ, 0)
        return ilp


def parse_uai_string(text: str) -> MrfInput:
    toks = []
    for line in text.split("\n"):
        line = line.split("#")[0]
        toks.extend(line.split())
    pos = 0

    def next_tok() -> str:
        nonlocal pos
        if pos >= len(toks):
            raise ValueError("unexpected end of UAI input")
        t = toks[pos]
        pos += 1
        return t

    first = toks[0] if toks else ""
    if first.upper() in ("MARKOV", "BAYES"):
        next_tok()
    mrf = MrfInput()
    nr_vars = int(next_tok())
    mrf.nr_labels = [int(next_tok()) for _ in range(nr_vars)]
    nr_cliques = int(next_tok())
    scopes: List[List[int]] = []
    for _ in range(nr_cliques):
        k = int(next_tok())
        scopes.append([int(next_tok()) for _ in range(k)])
    for scope in scopes:
        n_entries = int(next_tok())
        table = [float(next_tok()) for _ in range(n_entries)]
        if len(scope) == 1:
            i = scope[0]
            if n_entries != mrf.nr_labels[i]:
                raise ValueError(
                    f"unary table size {n_entries} != label count "
                    f"{mrf.nr_labels[i]} (misaligned UAI token stream)")
            prev = mrf.unaries.get(i)
            if prev is None:
                mrf.unaries[i] = table
            else:
                mrf.unaries[i] = [a + b for a, b in zip(prev, table)]
        elif len(scope) == 2:
            i, j = scope
            if n_entries != mrf.nr_labels[i] * mrf.nr_labels[j]:
                raise ValueError(
                    f"pairwise table size {n_entries} != "
                    f"{mrf.nr_labels[i]}*{mrf.nr_labels[j]} "
                    "(misaligned UAI token stream)")
            mrf.pairwise.append((i, j, table))
        else:
            raise ValueError("only unary and pairwise cliques supported")
    return mrf


def parse_uai_file(path: str) -> MrfInput:
    with open(path) as fh:
        return parse_uai_string(fh.read())
