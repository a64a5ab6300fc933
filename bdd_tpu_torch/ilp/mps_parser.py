"""MPS reader for 0-1 ILPs.

The reference only *writes* MPS (ILP_input.h:70-82 / write_mps); this reader
closes the round-trip so instances exported by us (or by other MIP tools in
the common fixed/free MPS dialect) can be read back. Accepted subset:

- sections NAME / ROWS / COLUMNS / RHS / BOUNDS / ENDATA (RANGES rejected);
- one objective row (``N``), constraint rows ``L``/``G``/``E``;
- COLUMNS ``MARKER`` / ``INTORG`` / ``INTEND`` lines are skipped (all
  variables are 0-1 in this model);
- BOUNDS: ``BV`` (binary, the default here), ``UP``/``UI`` with value 1,
  ``LO``/``LI`` with value 0, and ``FX`` 0/1 which become variable fixations
  applied via :meth:`ILPInput.reduce` (like LP ``Bounds``); anything outside
  {0, 1} is rejected — this is a 0-1 solver.

Coefficients are parsed as floats and stored as ints when integral (the
model's convention; fractional coefficients raise, matching the LP parser).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from bdd_tpu_torch.ilp.model import ILPInput, Ineq

_INEQ = {"L": Ineq.LEQ, "G": Ineq.GEQ, "E": Ineq.EQ}


def _num(tok: str) -> float:
    try:
        return float(tok)
    except ValueError as e:
        raise ValueError(f"MPS: bad number {tok!r}") from e


def _coeff(x: float) -> int:
    if x != int(x):
        raise ValueError(f"MPS: non-integral coefficient {x} (0-1 ILP model)")
    return int(x)


def parse_mps_string(text: str) -> ILPInput:
    ilp = ILPInput()
    section = None
    obj_row = None
    rows: Dict[str, Tuple[Ineq, str]] = {}  # name -> (ineq, name)
    # per-row accumulated terms: row -> list[(var, coeff)]
    terms: Dict[str, List[Tuple[int, int]]] = {}
    rhs: Dict[str, int] = {}
    row_order: List[str] = []
    zero_fix: List[int] = []
    one_fix: List[int] = []

    def var_of(name: str) -> int:
        if name in ilp.var_index:
            return ilp.var_index[name]
        return ilp.add_new_variable(name)

    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        is_header = not raw[0].isspace()
        toks = raw.split()
        if is_header:
            section = toks[0].upper()
            if section == "OBJSENSE" and len(toks) > 1:
                # one-line free-MPS form 'OBJSENSE MAX' — silently parsing a
                # maximization as minimization would be a wrong result
                if toks[1].upper() not in ("MIN", "MINIMIZE"):
                    raise ValueError("MPS: only minimization is supported")
            if section == "RANGES":
                raise ValueError("MPS: RANGES section not supported")
            if section not in (
                "NAME",
                "ROWS",
                "COLUMNS",
                "RHS",
                "BOUNDS",
                "OBJSENSE",
                "ENDATA",
            ):
                raise ValueError(f"MPS: unknown section {section!r}")
            continue
        if section == "OBJSENSE":
            if toks[0].upper() not in ("MIN", "MINIMIZE"):
                raise ValueError("MPS: only minimization is supported")
        elif section == "ROWS":
            tag, name = toks[0].upper(), toks[1]
            if tag == "N":
                if obj_row is not None:
                    raise ValueError("MPS: multiple objective rows")
                obj_row = name
            elif tag in _INEQ:
                if name in rows:
                    raise ValueError(f"MPS: duplicate row name {name!r}")
                rows[name] = (_INEQ[tag], name)
                terms[name] = []
                row_order.append(name)
            else:
                raise ValueError(f"MPS: unknown row type {tag!r}")
        elif section == "COLUMNS":
            if len(toks) >= 3 and toks[1].upper().startswith("'MARKER'"):
                continue  # INTORG/INTEND markers: everything is binary here
            col = toks[0]
            pairs = toks[1:]
            if len(pairs) % 2 != 0:
                raise ValueError(f"MPS: odd COLUMNS entry {raw!r}")
            v = var_of(col)
            for rname, val in zip(pairs[::2], pairs[1::2]):
                x = _num(val)
                if rname == obj_row:
                    ilp.add_to_objective(x, v)
                elif rname in rows:
                    terms[rname].append((v, _coeff(x)))
                else:
                    raise ValueError(f"MPS: unknown row {rname!r}")
        elif section == "RHS":
            pairs = toks[1:]
            if len(pairs) % 2 != 0:
                raise ValueError(f"MPS: odd RHS entry {raw!r}")
            for rname, val in zip(pairs[::2], pairs[1::2]):
                x = _num(val)
                if rname == obj_row:
                    ilp.constant_ += -x
                elif rname in rows:
                    rhs[rname] = _coeff(x)
                else:
                    raise ValueError(f"MPS: unknown RHS row {rname!r}")
        elif section == "BOUNDS":
            tag = toks[0].upper()
            if len(toks) < 3:
                raise ValueError(
                    f"MPS: bound line needs 'TAG SET VAR [VAL]': {raw!r}")
            name = toks[2]
            val = _num(toks[3]) if len(toks) > 3 else None
            if tag in ("UP", "UI", "LO", "LI", "FX") and val is None:
                raise ValueError(
                    f"MPS: bound {tag} requires a value: {raw!r}")
            v = var_of(name)
            if tag == "BV":
                pass
            elif tag in ("UP", "UI"):
                if val == 0:
                    zero_fix.append(v)
                elif val != 1:
                    raise ValueError(f"MPS: non-binary upper bound {val}")
            elif tag in ("LO", "LI"):
                if val == 1:
                    one_fix.append(v)
                elif val != 0:
                    raise ValueError(f"MPS: non-binary lower bound {val}")
            elif tag == "FX":
                if val == 1:
                    one_fix.append(v)
                elif val == 0:
                    zero_fix.append(v)
                else:
                    raise ValueError(f"MPS: non-binary fixation {val}")
            else:
                raise ValueError(f"MPS: unsupported bound type {tag!r}")
        elif section in ("NAME", "ENDATA", None):
            continue
        else:
            raise ValueError(f"MPS: line outside a known section: {raw!r}")

    for rname in row_order:
        ineq, _ = rows[rname]
        members = terms[rname]
        ilp.add_linear_constraint(
            [c for _, c in members],
            [v for v, _ in members],
            ineq,
            rhs.get(rname, 0),
            name=rname,
        )
    if zero_fix or one_fix:
        ilp = ilp.reduce(sorted(set(zero_fix)), sorted(set(one_fix)))
    return ilp


def parse_mps_file(path: str) -> ILPInput:
    with open(path) as fh:
        return parse_mps_string(fh.read())
