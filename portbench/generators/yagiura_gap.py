"""Generalized assignment instances of type D.

The type D rule of Martello and Toth, as P. C. Chu and J. E. Beasley give it
("A genetic algorithm for the generalised assignment problem", Computers &
OR 24 (1997) 17-23; OR-Library ``gapinfo.html``), from which M. Yagiura,
T. Ibaraki and F. Glover draw their larger instances (INFORMS J. Computing
16 (2004) 133-151; d60900 has m = 60 agents and n = 900 jobs). For agent i
and job j:

- weights w_ij: integers drawn from the discrete uniform U{1, ..., 100};
- costs c_ij = 111 - w_ij + e_ij, e_ij from the discrete uniform
  U{-10, ..., 10};
- capacities b_i = 0.8 * sum_j w_ij / m, rounded down (the weights are
  integers, so the feasible set is the same).

The problem minimises sum_ij c_ij x_ij subject to one capacity row
sum_j w_ij x_ij <= b_i an agent and one assignment row sum_i x_ij = 1 a job.
Variables ``x_<i>_<j>`` in agent-major order; the m capacity rows come
first, then the n assignment rows.

Parameters: ``agents`` (m) and ``jobs`` (n) from the configuration, and
``type``, which must be "D" where given.
"""
from __future__ import annotations

import numpy as np

from portbench.model import Model

MAX_WEIGHT = 100
COST_BASE = 111
COST_SPREAD = 10
CAPACITY_SHARE = 0.8


def draw(agents: int, jobs: int, seed: int):
    """(weights [m, n] int64, costs [m, n] int64, capacities [m] int64)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(1, MAX_WEIGHT + 1, size=(agents, jobs), dtype=np.int64)
    e = rng.integers(-COST_SPREAD, COST_SPREAD + 1, size=(agents, jobs), dtype=np.int64)
    # floor(0.8 * s / m) in integers: 4 s // (5 m)
    cap = 4 * w.sum(axis=1) // (5 * agents)
    return w, COST_BASE - w + e, cap


def make(params: dict, seed: int) -> Model:
    if params.get("type", "D") != "D":
        raise ValueError(f"type {params['type']!r}: this generator draws type D alone")
    m_, n_ = int(params["agents"]), int(params["jobs"])
    w, c, cap = draw(m_, n_, seed)
    m = Model()
    for i in range(m_):
        for j in range(n_):
            m.add_var(f"x_{i}_{j}")
    m.objective[:] = c.astype(np.float64).ravel().tolist()
    var = np.arange(m_ * n_).reshape(m_, n_)
    for i in range(m_):
        m.add_row(w[i], var[i], "<=", int(cap[i]), f"cap{i}")
    for j in range(n_):
        m.add_row([1] * m_, var[:, j], "=", 1, f"job{j}")
    return m
