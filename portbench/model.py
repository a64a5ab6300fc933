"""A 0-1 program as the benchmark makes it: variables, costs and linear rows.

The program under test receives only the LP text of a model (:meth:`Model.lp_text`);
the plain reference reads the model itself. Both see the same numbers: a cost
is what its 12 significant digits in the LP text say (:meth:`Model.costs`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

SENSES = ("<=", ">=", "=")


@dataclass
class Row:
    coeffs: List[int]
    vars: List[int]
    sense: str
    rhs: int
    name: str = ""


@dataclass
class Model:
    """min c^T x subject to the rows, x binary."""

    var_names: List[str] = field(default_factory=list)
    objective: List[float] = field(default_factory=list)
    rows: List[Row] = field(default_factory=list)

    def add_var(self, name: str) -> int:
        self.var_names.append(name)
        self.objective.append(0.0)
        return len(self.var_names) - 1

    def add_row(self, coeffs, variables, sense: str, rhs: int, name: str = "") -> None:
        if sense not in SENSES:
            raise ValueError(f"unknown sense {sense!r}")
        coeffs, variables = [int(c) for c in coeffs], [int(v) for v in variables]
        if len(coeffs) != len(variables):
            raise ValueError("a row needs one coefficient a variable")
        self.rows.append(Row(coeffs, variables, sense, int(rhs), name))

    def lp_text(self) -> str:
        """The LP text: every variable in the objective, in index order, so that
        a reader that numbers variables by first appearance numbers them as
        this model does."""
        out = ["Minimize"]
        terms = [f"{o:+.12g} {n}" for n, o in zip(self.var_names, self.objective)]
        out.append(" ".join(terms) if terms else "0")
        out.append("Subject To")
        for r in self.rows:
            parts = [f"{r.name}:"] if r.name else []
            parts += [f"{c:+d} {self.var_names[v]}" for c, v in zip(r.coeffs, r.vars)]
            parts += [r.sense, str(r.rhs)]
            out.append(" ".join(parts))
        out.append("End")
        return "\n".join(out) + "\n"

    def costs(self) -> np.ndarray:
        """float64 costs as the LP text states them."""
        return np.array([float(f"{o:+.12g}") for o in self.objective], dtype=np.float64)
