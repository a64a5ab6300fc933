"""Incremental min-marginal-agreement primal rounding.

Semantics of include/bdd_solver/incremental_mm_agreement_rounding.hxx:46-154 and
mm_primal_decoder (src/bdd_solver/mm_primal_decoder.cpp):

Each round: flush deferred deltas, compute per-layer min marginals, classify
every variable by the signs of its mm differences across its BDDs (one / zero /
equal / inconsistent); if all variables are one/zero the mm-argmin solution is
feasible and returned. Otherwise perturb: agreeing variables are pushed further
(delta on the opposite side), ties randomly, inconsistent ones towards the
smaller mm sum; rerun a short dual solve; grow delta geometrically.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from bdd_tpu_torch.solver.run import run_solver
from bdd_tpu_torch.utils.logging import bdd_log

MM_ZERO = 0
MM_ONE = 1
MM_EQUAL = 2
MM_INCONSISTENT = 3

_EPS = 1e-6


class MmDecoder:
    """Vectorized per-variable classification of per-layer min marginals."""

    def __init__(self, flat, m0: np.ndarray, m1: np.ndarray) -> None:
        self.flat = flat
        valid = flat.valid_layer_mask()
        v = flat.layer_var[valid]
        V = flat.nr_vars
        with np.errstate(invalid="ignore"):
            d = m1[valid] - m0[valid]
        # inf - inf -> NaN (layer infeasible both ways); mirror the device
        # classifier (_classify): infinite m0 side prefers 1, else prefers 0
        d = np.where(
            np.isfinite(d), d, np.where(np.isfinite(m0[valid]), 1e9, -1e9)
        )
        with np.errstate(invalid="ignore"):
            dmax = np.full(V, -np.inf)
            dmin = np.full(V, np.inf)
            amax = np.zeros(V)
            np.maximum.at(dmax, v, d)
            np.minimum.at(dmin, v, d)
            np.maximum.at(amax, v, np.abs(d))
        self.sum0 = np.zeros(V)
        self.sum1 = np.zeros(V)
        np.add.at(self.sum0, v, m0[valid])
        np.add.at(self.sum1, v, m1[valid])
        all_one = dmax < -_EPS  # every bdd strictly prefers 1
        all_zero = dmin > _EPS  # every bdd strictly prefers 0
        all_equal = amax <= _EPS
        self.types = np.full(V, MM_INCONSISTENT, dtype=np.int8)
        self.types[all_equal] = MM_EQUAL
        self.types[all_one] = MM_ONE
        self.types[all_zero] = MM_ZERO

    def statistics(self) -> Tuple[int, int, int, int]:
        return (
            int(np.sum(self.types == MM_ONE)),
            int(np.sum(self.types == MM_ZERO)),
            int(np.sum(self.types == MM_EQUAL)),
            int(np.sum(self.types == MM_INCONSISTENT)),
        )

    def can_reconstruct_solution(self) -> bool:
        return bool(np.all((self.types == MM_ONE) | (self.types == MM_ZERO)))

    def solution_from_mms(self) -> np.ndarray:
        sol = np.where(
            self.types == MM_ONE,
            1,
            np.where(self.types == MM_ZERO, 0, (self.sum0 > self.sum1).astype(int)),
        )
        return sol.astype(np.int8)


def min_marginals_per_var(flat, m0: np.ndarray, m1: np.ndarray):
    """CSR-style per-variable stacked min marginals: returns (offsets [V+1],
    m0_sorted, m1_sorted) where variable v's layer marginals occupy
    [offsets[v], offsets[v+1]) (ref: include/min_marginal_utils.h:11-52)."""
    valid = flat.valid_layer_mask()
    v = flat.layer_var[valid]
    order = np.argsort(v, kind="stable")
    vs = v[order]
    offsets = np.searchsorted(vs, np.arange(flat.nr_vars + 1))
    return offsets, m0[valid][order], m1[valid][order]


def compute_initial_delta(flat, m0: np.ndarray, m1: np.ndarray) -> float:
    """10th-percentile of per-variable |avg mm difference|
    (ref: incremental_mm_agreement_rounding.hxx:18-32)."""
    valid = flat.valid_layer_mask()
    v = flat.layer_var[valid]
    V = flat.nr_vars
    with np.errstate(invalid="ignore"):
        d = np.where(np.isfinite(m1[valid] - m0[valid]), m1[valid] - m0[valid], 0.0)
    sums = np.zeros(V)
    np.add.at(sums, v, d)
    counts = np.maximum(flat.num_bdds_per_var, 1)
    diffs = np.abs(sums) / counts
    k = int(0.1 * V)
    val = float(np.partition(diffs, k)[k]) if V > 0 else 0.1
    return max(val, 1e-6)


def objective_tilt(objective, nr_vars: int) -> np.ndarray:
    """Per-variable tilt in [-1, 1] from the (solver-order) objective: the
    cost normalized by the median nonzero magnitude. Negative cost (variable
    pays to be 1) tilts negative = toward 1."""
    c = np.zeros(nr_vars)
    o = np.asarray(objective, dtype=np.float64)
    c[: min(nr_vars, o.size)] = o[:nr_vars]
    nz = np.abs(c[c != 0])
    scale = float(np.median(nz)) if nz.size else 1.0
    return np.clip(c / max(scale, 1e-12), -1.0, 1.0)


def incremental_mm_rounding(
    s,
    init_delta: float = math.inf,
    delta_growth_rate: float = 1.1,
    num_itr_lb: int = 100,
    num_rounding_itr: int = 500,
    seed: int = 0,
    verbose: bool = True,
    objective_bias: float = 0.0,
    objective=None,
) -> Optional[np.ndarray]:
    """Returns a 0/1 assignment over all variables or None.

    ``s`` duck interface: .f (FlatBdds), min_marginals(), distribute_delta(),
    update_costs(lo_per_var, hi_per_var), iteration(), lower_bound().

    ``objective_bias`` > 0 (with ``objective``, solver variable order) tilts
    the random tie-breaking of EQUAL variables toward the primal objective:
    the uniform draw deciding the perturbation direction is shifted by
    ``bias * tilt_v`` where tilt_v = clip(c_v / median|c|, -1, 1). On
    LP-loose instances the converged duals make most variables ties, and the
    reference's symmetric coin flips can cascade into poor feasible points
    (measured on dense random graph matching: mm rounding -29.9 vs a family
    greedy's -49.1, BENCH.md primal-quality table); re-injecting the primal
    cost preference at ties only — agreeing/inconsistent variables keep the
    reference semantics — repairs this while preserving feasibility logic.
    bias=0 reproduces the reference semantics draw-for-draw."""
    flat = s.f
    rng = np.random.RandomState(seed)
    tilt = (
        objective_tilt(objective, flat.nr_vars)
        if objective_bias > 0.0 and objective is not None
        else None
    )

    if math.isinf(init_delta):
        s.distribute_delta()
        m0, m1 = s.min_marginals()
        init_delta = compute_initial_delta(flat, m0, m1)
    if verbose:
        bdd_log(
            f"[incremental primal rounding] initial delta = {init_delta:.6g}, "
            f"growth rate = {delta_growth_rate}"
        )
    cur_delta = init_delta / delta_growth_rate

    for rnd in range(num_rounding_itr):
        cur_delta = min(cur_delta * delta_growth_rate, 1e6)
        s.distribute_delta()
        m0, m1 = s.min_marginals()
        dec = MmDecoder(flat, m0, m1)
        n1, n0, neq, ninc = dec.statistics()
        if verbose:
            V = flat.nr_vars
            bdd_log(
                f"[incremental primal rounding] round {rnd}, delta {cur_delta:.4g}: "
                f"one {100 * n1 / V:.1f}%, zero {100 * n0 / V:.1f}%, "
                f"equal {100 * neq / V:.1f}%, inconsistent {100 * ninc / V:.1f}%"
            )
        if dec.can_reconstruct_solution():
            if verbose:
                bdd_log("[incremental primal rounding] found feasible solution")
            return dec.solution_from_mms()

        V = flat.nr_vars
        lo_upd = np.zeros(V)
        hi_upd = np.zeros(V)
        t = dec.types
        lo_upd[t == MM_ONE] = cur_delta
        hi_upd[t == MM_ZERO] = cur_delta
        # ties: random sign, magnitude |r|*delta with r ~ U(-delta, delta)
        # (reference semantics, incremental_mm_agreement_rounding.hxx:118-131)
        eq = t == MM_EQUAL
        r = rng.uniform(-cur_delta, cur_delta, size=int(np.sum(eq)))
        # objective tilt shifts the direction draw only; magnitude keeps the
        # reference's |r| * delta
        r_dir = r + objective_bias * cur_delta * tilt[eq] if tilt is not None else r
        lo_eq = np.where(r_dir < 0, np.abs(r) * cur_delta, 0.0)
        hi_eq = np.where(r_dir >= 0, np.abs(r) * cur_delta, 0.0)
        lo_upd[eq] = lo_eq
        hi_upd[eq] = hi_eq
        # inconsistent: push towards the smaller mm sum
        inc = t == MM_INCONSISTENT
        r = rng.uniform(-cur_delta, cur_delta, size=int(np.sum(inc)))
        towards_zero = dec.sum0[inc] < dec.sum1[inc]
        lo_inc = np.where(~towards_zero, np.abs(r) * cur_delta, 0.0)
        hi_inc = np.where(towards_zero, np.abs(r) * cur_delta, 0.0)
        lo_upd[inc] = lo_inc
        hi_upd[inc] = hi_inc

        s.update_costs(lo_upd, hi_upd)
        run_solver(
            s,
            max_iter=num_itr_lb,
            tolerance=1e-7,
            improvement_slope=1e-4,
            time_limit=math.inf,
            verbose=False,
            block_size=getattr(s, "default_block_size", 1),
        )
        if verbose:
            bdd_log(
                f"[incremental primal rounding] lower bound = {s.lower_bound():.6f}"
            )
    if verbose:
        bdd_log("[incremental primal rounding] no solution found")
    return None
