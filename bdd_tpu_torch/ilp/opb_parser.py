"""OPB (pseudo-Boolean) format parser.

Dialect of src/ILP/OPB_parser.cpp: '*' comment lines, an objective line
``min: <terms> ;`` and ``;``-terminated constraints ``<terms> (<=|>=|=) rhs ;``.
Products ``x1 x2`` inside a term form monomials (nonlinear constraints).
Negated literals ``~x`` are substituted by (1 - x).
"""
from __future__ import annotations

import re
from typing import List, Tuple

from bdd_tpu_torch.ilp.model import ILPInput, Ineq

_VAR = r"~?[A-Za-z][A-Za-z0-9_\-/(){},]*"
_TERM_RE = re.compile(rf"\s*([+-])?\s*(\d+\.?\d*)?\s*\*?\s*((?:{_VAR}\s*)+)")


class OpbParseError(ValueError):
    pass


def _parse_terms(text: str, ilp: ILPInput):
    """-> list of (coeff, [(var, negated), ...]) terms. Bare constants are
    not part of the OPB term grammar and raise."""
    out = []
    pos, n = 0, len(text)
    while pos < n:
        while pos < n and text[pos].isspace():
            pos += 1
        if pos >= n:
            break
        m = _TERM_RE.match(text, pos)
        if not m or m.end() == pos:
            raise OpbParseError(f"cannot parse term at {text[pos:pos+40]!r}")
        sign, coeff_s, vars_s = m.group(1), m.group(2), m.group(3)
        coeff = float(coeff_s) if coeff_s else 1.0
        if sign == "-":
            coeff = -coeff
        lits = vars_s.split()
        mono = []
        for lit in lits:
            neg = lit.startswith("~")
            name = lit[1:] if neg else lit
            mono.append((ilp.get_or_create_variable(name), neg))
        out.append((coeff, mono))
        pos = m.end()
    return out


def _expand_negations(coeff: float, mono: List[Tuple[int, bool]]):
    """Expand prod of literals with negations into +- monomials over plain
    variables: ~x = 1 - x. Yields (coeff, tuple(vars))."""
    terms = [(coeff, ())]
    for v, neg in mono:
        new = []
        for c, vs in terms:
            if neg:
                new.append((c, vs))  # the constant-1 branch
                new.append((-c, vs + (v,)))
            else:
                new.append((c, vs + (v,)))
        terms = new
    return terms


def parse_opb_string(text: str) -> ILPInput:
    ilp = ILPInput()
    # strip comments
    lines = [l for l in text.split("\n") if not l.strip().startswith("*")]
    body = "\n".join(lines)
    statements = [s.strip() for s in body.split(";") if s.strip()]
    if not statements:
        raise OpbParseError("empty opb")
    first = statements[0]
    start_idx = 0
    if first.lower().startswith("min:"):
        terms = _parse_terms(first[4:], ilp)
        for coeff, mono in terms:
            for c, vs in _expand_negations(coeff, mono):
                if len(vs) == 0:
                    ilp.constant_ += c
                elif len(vs) == 1:
                    ilp.add_to_objective(c, vs[0])
                else:
                    raise OpbParseError("nonlinear objective not supported")
        start_idx = 1
    for stmt in statements[start_idx:]:
        m = re.search(r"(<=|>=|=)", stmt)
        if not m:
            raise OpbParseError(f"no relation in {stmt!r}")
        lhs, op, rhs_s = stmt[: m.start()], m.group(1), stmt[m.end() :]
        rhs = float(rhs_s.strip())
        if rhs != int(rhs):
            raise OpbParseError("non-integral rhs")
        rhs = int(rhs)
        terms = _parse_terms(lhs, ilp)
        coeffs: List[int] = []
        monomials: List[Tuple[int, ...]] = []
        for coeff, mono in terms:
            for c, vs in _expand_negations(coeff, mono):
                if c != int(c):
                    raise OpbParseError("non-integral coefficient")
                if len(vs) == 0:
                    rhs -= int(c)
                else:
                    coeffs.append(int(c))
                    monomials.append(vs)
        ineq = {"<=": Ineq.LEQ, ">=": Ineq.GEQ, "=": Ineq.EQ}[op]
        ilp.add_constraint(coeffs, monomials, ineq, rhs)
    ilp.normalize()
    return ilp


def parse_opb_file(path: str) -> ILPInput:
    with open(path) as fh:
        return parse_opb_string(fh.read())


def convert_lp_to_opb(lp_text: str) -> str:
    """CLI converter parity (ref: src/ILP/convert_lp_to_opb.cpp)."""
    from bdd_tpu_torch.ilp.lp_parser import parse_lp_string

    return parse_lp_string(lp_text).write_opb()


def convert_opb_to_lp(opb_text: str) -> str:
    return parse_opb_string(opb_text).write_lp()
