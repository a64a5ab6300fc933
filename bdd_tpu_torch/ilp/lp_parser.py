"""LP-format parser.

Accepts the dialect of the reference PEGTL grammar (src/ILP/ILP_parser.cpp:135-153):

    \\ comment lines
    Minimize
    <objective terms over several lines; optional trailing constant>
    Subject To
    [name:] <terms with optional monomial products 'x*y'> (<=|>=|=) rhs
    ...
    Bounds          (optional: 'x = 0', 'x <= 0', '1 <= x' fix variables)
    Binaries        (optional: ignored, all variables are binary)
    Generals        (optional: ignored)
    Coalesce        (optional: lines of constraint names forming BDD groups)
    End

Variable fixations from Bounds are applied via :meth:`ILPInput.reduce`
(ref: ILP_parser.cpp:452-481).
"""
from __future__ import annotations

import re
from typing import List, Tuple

from bdd_tpu_torch.ilp.model import ILPInput, Ineq

# Variable names: start with a letter; continue with the reference's generous
# identifier charset (ILP_parser.cpp:46-49).
_VAR = r"[A-Za-z][A-Za-z0-9_\-/(){},#;\[\].']*"
_NUM = r"(?:\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)"

# One term: optional sign, optional coefficient, optional '*', monomial
# (variables joined by '*' or whitespace).
_TERM_RE = re.compile(
    rf"\s*([+-])?\s*({_NUM})?\s*\*?\s*({_VAR}(?:\s*\*\s*{_VAR})*)"
)
_CONST_RE = re.compile(rf"\s*([+-])\s*({_NUM})\s*$")
_INEQ_SPLIT_RE = re.compile(r"(<=|>=|=)")
_NAME_RE = re.compile(r"^\s*([^\s:]+)\s*:")


class LpParseError(ValueError):
    pass


def _parse_terms(text: str, allow_constant: bool):
    """Parse '+2 x - y + 3 a*b [- 1.5]' -> ([(coeff, (v1,...)), ...], constant)."""
    terms: List[Tuple[float, Tuple[str, ...]]] = []
    constant = 0.0
    pos = 0
    n = len(text)
    while pos < n:
        while pos < n and text[pos] in " \t\n\r":
            pos += 1
        if pos >= n:
            break
        m = _TERM_RE.match(text, pos)
        if m is None or m.end() == pos:
            # maybe a trailing constant like '+ 3'
            if allow_constant:
                mc = _CONST_RE.match(text, pos)
                if mc:
                    sign = -1.0 if mc.group(1) == "-" else 1.0
                    constant += sign * float(mc.group(2))
                    pos = mc.end()
                    continue
            raise LpParseError(f"cannot parse terms at: {text[pos:pos+60]!r}")
        sign_s, coeff_s, mono_s = m.group(1), m.group(2), m.group(3)
        coeff = float(coeff_s) if coeff_s is not None else 1.0
        if sign_s == "-":
            coeff = -coeff
        variables = tuple(v.strip() for v in re.split(r"\s*\*\s*", mono_s))
        terms.append((coeff, variables))
        pos = m.end()
    return terms, constant


def parse_lp_string(text: str) -> ILPInput:
    ilp = ILPInput()
    lines = text.split("\n")
    i = 0

    def skip_blank_and_comments(i: int) -> int:
        while i < len(lines):
            s = lines[i].strip()
            if s == "" or s.startswith("\\"):
                i += 1
            else:
                break
        return i

    i = skip_blank_and_comments(i)
    if i >= len(lines) or lines[i].strip().lower() not in ("minimize", "min"):
        raise LpParseError("expected 'Minimize'")
    i += 1

    # objective: everything until 'Subject To'
    obj_lines: List[str] = []
    while i < len(lines):
        s = lines[i].strip()
        if s.lower() in ("subject to", "st", "s.t.", "such that"):
            i += 1
            break
        if not s.startswith("\\"):
            obj_lines.append(lines[i])
        i += 1
    else:
        raise LpParseError("expected 'Subject To'")
    obj_text = " ".join(obj_lines).strip()
    if obj_text:
        terms, constant = _parse_terms(obj_text, allow_constant=True)
        ilp.constant_ += constant
        for coeff, mono in terms:
            if len(mono) != 1:
                raise LpParseError("objective must be linear")
            ilp.add_to_objective(coeff, mono[0])

    # constraints until Bounds/Binaries/Generals/Coalesce/End
    section_words = {
        "bounds", "binaries", "generals", "binary", "general", "coalesce",
        "end",
    }
    pending = ""
    while i < len(lines):
        s = lines[i].strip()
        if s == "" or s.startswith("\\"):
            i += 1
            continue
        if s.lower() in section_words:
            if pending:
                # a section keyword must not be swallowed into a constraint
                # missing its relation — that would fabricate variables and
                # silently drop the following section
                raise LpParseError(
                    f"incomplete constraint before section {s!r}: "
                    f"{pending!r}")
            break
        pending = (pending + " " + s).strip()
        # a constraint is complete once it contains an inequality AND a
        # non-empty right-hand side (the rhs may sit on the next line)
        m = _INEQ_SPLIT_RE.search(pending)
        if m and pending[m.end():].strip():
            _add_constraint_line(ilp, pending)
            pending = ""
        i += 1
    if pending:
        raise LpParseError(f"dangling constraint text: {pending!r}")

    zero_fix: List[int] = []
    one_fix: List[int] = []
    coalesce_names: List[List[str]] = []
    while i < len(lines):
        s = lines[i].strip()
        low = s.lower()
        if s == "" or s.startswith("\\"):
            i += 1
            continue
        if low == "end":
            break
        if low == "bounds":
            i += 1
            while i < len(lines):
                b = lines[i].strip()
                if b == "" or b.startswith("\\"):
                    i += 1
                    continue
                if b.lower() in section_words:
                    break
                _parse_bound_line(ilp, b, zero_fix, one_fix)
                i += 1
            continue
        if low in ("binaries", "generals", "binary", "general"):
            i += 1
            while i < len(lines):
                b = lines[i].strip()
                if b.lower() in section_words:
                    break
                i += 1
            continue
        if low == "coalesce":
            i += 1
            while i < len(lines):
                b = lines[i].strip()
                if b == "" or b.startswith("\\"):
                    i += 1
                    continue
                if b.lower() in section_words:
                    break
                coalesce_names.append(b.split())
                i += 1
            continue
        raise LpParseError(f"unexpected line: {s!r}")

    if coalesce_names:
        name_to_idx = {
            c.name: j for j, c in enumerate(ilp.constraints_) if c.name
        }
        for group in coalesce_names:
            try:
                ilp.add_coalesce_set([name_to_idx[n] for n in group])
            except KeyError as e:
                raise LpParseError(f"unknown constraint name in Coalesce: {e}")

    if zero_fix or one_fix:
        ilp = ilp.reduce(zero_fix, one_fix)
    return ilp


def _add_constraint_line(ilp: ILPInput, line: str) -> None:
    name = ""
    m = _NAME_RE.match(line)
    if m:
        name = m.group(1)
        line = line[m.end() :]
    parts = _INEQ_SPLIT_RE.split(line, maxsplit=1)
    if len(parts) != 3:
        raise LpParseError(f"cannot parse constraint: {line!r}")
    lhs_s, op_s, rhs_s = parts
    ineq = {"<=": Ineq.LEQ, ">=": Ineq.GEQ, "=": Ineq.EQ}[op_s]
    try:
        rhs = float(rhs_s.strip())
    except ValueError:
        raise LpParseError(
            f"cannot parse right-hand side {rhs_s.strip()!r} in "
            f"constraint {line!r} (ranged constraints are not supported)")
    if rhs != int(rhs):
        raise LpParseError(f"right-hand side must be integral: {rhs_s!r}")
    terms, constant = _parse_terms(lhs_s, allow_constant=True)
    rhs -= constant
    coeffs: List[int] = []
    monomials: List[Tuple[int, ...]] = []
    for coeff, mono in terms:
        if coeff != int(coeff):
            raise LpParseError(f"constraint coefficients must be integral: {coeff}")
        coeffs.append(int(coeff))
        monomials.append(tuple(ilp.get_or_create_variable(v) for v in mono))
    ilp.add_constraint(coeffs, monomials, ineq, int(rhs), name)


_BOUND_FIX = re.compile(rf"^({_VAR})\s*=\s*([01])$")
_BOUND_LE = re.compile(rf"^({_VAR})\s*<=\s*([01])$")
_BOUND_GE = re.compile(rf"^([01])\s*<=\s*({_VAR})(?:\s*<=\s*([01]))?$")


def _parse_bound_line(
    ilp: ILPInput, line: str, zero_fix: List[int], one_fix: List[int]
) -> None:
    line = line.strip()
    m = _BOUND_FIX.match(line)
    if m:
        v = ilp.get_or_create_variable(m.group(1))
        (one_fix if m.group(2) == "1" else zero_fix).append(v)
        return
    m = _BOUND_LE.match(line)
    if m:
        if m.group(2) == "0":
            zero_fix.append(ilp.get_or_create_variable(m.group(1)))
        return  # x <= 1 is vacuous
    m = _BOUND_GE.match(line)
    if m:
        lb, var, ub = m.group(1), m.group(2), m.group(3)
        v = ilp.get_or_create_variable(var)
        if lb == "1":
            one_fix.append(v)
        elif ub == "0":
            zero_fix.append(v)
        return
    raise LpParseError(f"cannot parse bound line: {line!r}")


def parse_lp_file(path: str) -> ILPInput:
    with open(path, "r") as f:
        return parse_lp_string(f.read())
