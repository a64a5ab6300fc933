"""Multidimensional knapsack instances by Chu and Beasley's generator.

P. C. Chu and J. E. Beasley, "A genetic algorithm for the multidimensional
knapsack problem", J. Heuristics 4 (1998) 63-86; the OR-Library classes
``mknapcb1`` to ``mknapcb9``. For m rows and n items:

- weights w_ij: integers drawn from the discrete uniform U{0, ..., 1000};
- capacities b_i = tightness * sum_j w_ij (rounded down: the weights are
  integers, so the feasible set is the same);
- profits p_j = sum_i w_ij / m + 500 q_j, q_j from the continuous U(0, 1).

The problem maximises sum_j p_j x_j; the model minimises sum_j -p_j x_j.
A weight of 0 leaves its item out of that row.

Parameters: ``rows`` (m), ``items`` (n) from the configuration, ``tightness``
from the traffic mix.
"""
from __future__ import annotations

import math

import numpy as np

from portbench.model import Model

MAX_WEIGHT = 1000
PROFIT_SPREAD = 500.0


def draw(rows: int, items: int, tightness: float, seed: int):
    """(weights [m, n] int64, capacities [m] int64, profits [n] float64)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, MAX_WEIGHT + 1, size=(rows, items), dtype=np.int64)
    q = rng.random(items)
    cap = np.array([math.floor(tightness * int(s)) for s in w.sum(axis=1)], dtype=np.int64)
    profit = w.sum(axis=0) / rows + PROFIT_SPREAD * q
    return w, cap, profit


def make(params: dict, seed: int) -> Model:
    w, cap, profit = draw(params["rows"], params["items"], params["tightness"], seed)
    m = Model()
    for j in range(w.shape[1]):
        m.add_var(f"x{j}")
        m.objective[j] = -float(profit[j])
    for i in range(w.shape[0]):
        nz = np.nonzero(w[i])[0]
        m.add_row(w[i, nz], nz, "<=", int(cap[i]), f"row{i}")
    return m
