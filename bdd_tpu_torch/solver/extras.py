"""Solver utilities over the solvers' duck interface (``.f``,
``update_costs``, ``update_layer_costs``, ``min_marginals``,
``distribute_delta``): variable fixing, Wedelin rounding, easy-variable
fixing. Counterpart of bdd_tpu/solver/extras.py:37-190, numpy on the host.

- fix_variable: fixation = +inf cost on the excluded side (shape-stable, the
  reference's scheme, bdd_mma_base.cpp:295-311).
- wedelin_rounding: Wedelin-style perturbation heuristic
  (incremental_mm_agreement_rounding.hxx:159-283). Perturbations are tracked
  per variable with exponential decay theta and mm-proportional strength
  kappa; the draws come from ``np.random.RandomState(seed)``, as in the JAX
  package, so both follow one trajectory.
- solve_easy_variables: fix strongly-agreeing variables from min marginals and
  return the reduced hard core.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from bdd_tpu_torch.solver.rounding import (
    MM_EQUAL,
    MM_INCONSISTENT,
    MM_ONE,
    MM_ZERO,
    MmDecoder,
)
from bdd_tpu_torch.solver.run import run_solver
from bdd_tpu_torch.utils.logging import bdd_log


def fix_variable(s, var: int, value: int) -> None:
    """Force variable to value by +inf cost on the other side."""
    V = s.f.nr_vars
    lo_upd = np.zeros(V)
    hi_upd = np.zeros(V)
    if value == 1:
        lo_upd[var] = math.inf
    else:
        hi_upd[var] = math.inf
    s.update_costs(lo_upd, hi_upd)


def fix_variables(s, assignments: Dict[int, int]) -> None:
    V = s.f.nr_vars
    lo_upd = np.zeros(V)
    hi_upd = np.zeros(V)
    for var, value in assignments.items():
        if value == 1:
            lo_upd[var] = math.inf
        else:
            hi_upd[var] = math.inf
    s.update_costs(lo_upd, hi_upd)


def wedelin_rounding(
    s,
    theta: float = 0.8,
    delta: float = 0.01,
    kappa_min: float = 0.1,
    kappa_max: float = 0.95,
    kappa_step: float = 0.05,
    alpha: float = 0.5,
    num_itr_lb: int = 20,
    num_outer_iterations: int = 500,
    seed: int = 0,
    verbose: bool = True,
) -> Optional[np.ndarray]:
    assert 0.0 <= theta <= 1.0 and delta >= 0.0
    assert 0.0 <= kappa_min < kappa_max < 1.0
    rng = np.random.RandomState(seed)
    flat = s.f
    V = flat.nr_vars
    per_layer = hasattr(s, "update_layer_costs")
    L = len(flat.layer_var) if per_layer else V
    p_lo = np.zeros(L)
    p_hi = np.zeros(L)
    kappa = kappa_min
    for it in range(num_outer_iterations):
        if kappa > kappa_max:
            break
        s.distribute_delta()
        m0, m1 = s.min_marginals()
        dec = MmDecoder(flat, m0, m1)
        if dec.can_reconstruct_solution():
            if verbose:
                bdd_log("[wedelin rounding] found primal solution")
            return dec.solution_from_mms()
        n1, n0, neq, ninc = dec.statistics()
        if verbose:
            bdd_log(
                f"[wedelin rounding] iter {it} kappa {kappa:.3f}: "
                f"one {n1} zero {n0} equal {neq} inconsistent {ninc}"
            )
        # mm-proportional strength, per (var, bdd) layer as in the
        # reference (hxx:240 uses |m1_ij - m0_ij| per layer — a variable-
        # averaged |sum| would vanish exactly on mixed-sign inconsistent
        # variables, the ones the push must break)
        valid_all = flat.valid_layer_mask()
        with np.errstate(invalid="ignore"):
            d_layer = m1 - m0
        abs_layer = np.where(
            valid_all & np.isfinite(d_layer), np.abs(d_layer), 0.0
        )
        counts = np.maximum(flat.num_bdds_per_var, 1)
        abs_sum = np.zeros(V)
        np.add.at(abs_sum, flat.layer_var[valid_all], abs_layer[valid_all])
        t = dec.types
        r = rng.uniform(-delta, delta, size=V)
        push_lo = (t == MM_ONE) | (((t == MM_EQUAL) | (t == MM_INCONSISTENT)) & (r < 0))
        push_hi = (t == MM_ZERO) | (((t == MM_EQUAL) | (t == MM_INCONSISTENT)) & (r >= 0))
        if per_layer:
            # per-(var,bdd) perturbation bookkeeping with exponential decay
            # (the reference's p / p_delta layer arrays,
            # incremental_mm_agreement_rounding.hxx:190-196)
            lv = flat.layer_var
            lvc = np.minimum(lv, V - 1)
            Delta_layer = kappa / (1 - kappa) * abs_layer + delta
            d_lo = -(1 - theta) * p_lo
            d_hi = -(1 - theta) * p_hi
            dl = np.where(push_lo[lvc] & valid_all, Delta_layer, 0.0)
            dh = np.where(push_hi[lvc] & valid_all, Delta_layer, 0.0)
            d_lo = d_lo + dl
            d_hi = d_hi + dh
            s.update_layer_costs(d_lo, d_hi)
            p_lo += d_lo
            p_hi += d_hi
        else:
            # per-variable totals matching the per-layer magnitudes:
            # update_costs splits by 1/num_bdds per layer, so the total is
            # sum_j Delta_ij = kappa/(1-kappa) * sum_j |mm_ij| + n * delta
            Delta_total = kappa / (1 - kappa) * abs_sum + delta * counts
            d_lo = -(1 - theta) * p_lo + np.where(push_lo, Delta_total, 0.0)
            d_hi = -(1 - theta) * p_hi + np.where(push_hi, Delta_total, 0.0)
            s.update_costs(d_lo, d_hi)
            p_lo += d_lo
            p_hi += d_hi
        run_solver(
            s,
            max_iter=num_itr_lb,
            tolerance=1e-7,
            improvement_slope=1e-4,
            time_limit=math.inf,
            verbose=False,
            block_size=getattr(s, "default_block_size", 1),
        )
        frac_undecided = max((neq + ninc) / max(V, 1), 1e-12)
        kappa += kappa_step * math.exp(alpha * math.log(frac_undecided))
    if verbose:
        bdd_log("[wedelin rounding] no solution found")
    return None


def solve_easy_variables(
    s, ilp, margin: float = 1e-3
) -> Tuple[Dict[int, int], "object"]:
    """Fix variables whose min marginals agree across all their BDDs by more
    than ``margin``; return ({var: value}, reduced hard-core ILP).

    The caller solves the (much smaller) core exactly and merges solutions
    (the FastDOG + exact-solver hybrid of solve_easy_variables.py)."""
    s.distribute_delta()
    m0, m1 = s.min_marginals()
    flat = s.f
    valid = flat.valid_layer_mask()
    v = flat.layer_var[valid]
    V = flat.nr_vars
    with np.errstate(invalid="ignore"):
        d = m1[valid] - m0[valid]
        d = np.where(np.isnan(d), 0.0, d)
    dmin = np.full(V, np.inf)
    dmax = np.full(V, -np.inf)
    np.minimum.at(dmin, v, d)
    np.maximum.at(dmax, v, d)
    fixations: Dict[int, int] = {}
    for var in range(min(V, ilp.nr_variables())):
        if dmax[var] < -margin:
            fixations[var] = 1
        elif dmin[var] > margin:
            fixations[var] = 0
    reduced = ilp.reduce(
        [v for v, val in fixations.items() if val == 0],
        [v for v, val in fixations.items() if val == 1],
    )
    return fixations, reduced
