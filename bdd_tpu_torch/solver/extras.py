"""Solver utilities over the solvers' duck interface (``.f``,
``update_costs``, ``update_layer_costs``, ``min_marginals``,
``distribute_delta``): variable fixing, Wedelin rounding, easy-variable
fixing, checkpoints, the Lagrange constraint matrix, the float64 cost
transfer to the native solver and the exact solves. Counterpart of
bdd_tpu/solver/extras.py, numpy on the host.

- fix_variable: fixation = +inf cost on the excluded side (shape-stable, the
  reference's scheme, bdd_mma_base.cpp:295-311).
- wedelin_rounding: Wedelin-style perturbation heuristic
  (incremental_mm_agreement_rounding.hxx:159-283). Perturbations are tracked
  per variable with exponential decay theta and mm-proportional strength
  kappa; the draws come from ``np.random.RandomState(seed)``, as in the JAX
  package, so both follow one trajectory.
- solve_easy_variables: fix strongly-agreeing variables from min marginals and
  return the reduced hard core.
- save_state/load_state: checkpoint the dual state in the JAX package's file
  format, so that a checkpoint written by either package loads in the other.
- transfer_costs_to_native: warm-start the native float64 solver from a
  uniform state (the float32 -> float64 certification path).
- exact_min_via_meld / exact_min_bruteforce: exact optima of small models.
"""
from __future__ import annotations

import math
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bdd_tpu_torch.solver.rounding import (
    MM_EQUAL,
    MM_INCONSISTENT,
    MM_ONE,
    MM_ZERO,
    MmDecoder,
)
from bdd_tpu_torch.solver.dense import SolverState as DenseState
from bdd_tpu_torch.solver.layout import UniformState, state_from_buckets
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


# ------------------------------------------------------------- checkpointing
def _state_leaves(state: UniformState):
    """The leaves of the JAX package's ``UniformState`` pytree, in its order:
    lo..., hi..., def_mm... per bucket [H, B], then cft... per bucket
    [H, P, B] (a wide bucket's [H, B, P] storage is not what is written)."""
    return [np.ascontiguousarray(x.cpu().numpy())
            for x in (*state.lo, *state.hi, *state.def_mm, *state.cft)]


def save_state(s, path: str) -> None:
    """Checkpoint the dual state of a uniform-backend solver (UniformSolver,
    SmoothSolver, HybridSolver's device side), of a DenseSolver or of a
    RefSolver, as the JAX package writes it: a pickle of {"kind": class name,
    "state": [numpy leaves]} (a dense state: [lo, hi, def_mm, cft], the
    leaves of a ``JaxSolver``'s; RefSolver: its per-layer "lo", "hi",
    "def_mm")."""
    state = getattr(s, "state", None)
    if isinstance(state, UniformState):
        blob = {"kind": type(s).__name__, "state": _state_leaves(state)}
    elif isinstance(state, DenseState):
        blob = {"kind": type(s).__name__,
                "state": [np.ascontiguousarray(x.cpu().numpy()) for x in state]}
    elif hasattr(s, "lo_cost"):
        blob = {
            "kind": "RefSolver",
            "lo": np.asarray(s.lo_cost),
            "hi": np.asarray(s.hi_cost),
            "def_mm": np.asarray(s.def_mm),
        }
    else:
        raise ValueError(f"no dual state to checkpoint in a {type(s).__name__}")
    with open(path, "wb") as fh:
        pickle.dump(blob, fh)


def load_state(s, path: str) -> None:
    """Load a checkpoint of :func:`save_state` (or of the JAX package's) into
    a solver of the same layout; raises ValueError when its structure or
    shapes differ from the solver's."""
    with open(path, "rb") as fh:
        blob = pickle.load(fh)
    if blob["kind"] == "RefSolver":
        if not hasattr(s, "lo_cost"):
            raise ValueError(f"a RefSolver checkpoint does not load into a {type(s).__name__}")
        s.lo_cost = blob["lo"].copy()
        s.hi_cost = blob["hi"].copy()
        s.def_mm = blob["def_mm"].copy()
        s._cft = None
        return
    template = getattr(s, "state", None)
    if not isinstance(template, (UniformState, DenseState)):
        raise ValueError(f"a {blob['kind']} checkpoint does not load into a {type(s).__name__}")
    arrays = blob["state"]
    dense = isinstance(template, DenseState)
    leaves = (list(template) if dense
              else [*template.lo, *template.hi, *template.def_mm, *template.cft])
    if len(arrays) != len(leaves) or any(
        np.asarray(a).shape != tuple(t.shape) for a, t in zip(arrays, leaves)
    ):
        raise ValueError(
            f"checkpoint does not match the solver's state structure "
            f"({len(arrays)} vs {len(leaves)} leaves / shape mismatch) "
            "— geometry/backend mismatch")
    geom = s.geom
    if dense:
        s.state = DenseState(*(torch.from_numpy(np.array(a)).to(geom.device, geom.dtype)
                               for a in arrays))
        return
    nb = len(template.lo)

    def t(xs):
        return [torch.from_numpy(np.array(x)).to(geom.device, geom.dtype) for x in xs]

    s.state = state_from_buckets(geom, *(t(arrays[k * nb:(k + 1) * nb]) for k in range(4)))


def lagrange_constraint_matrix(s):
    """Sparse variable × dual-layer incidence of the Lagrange decomposition:
    entry (v, c) = 1 iff dual layer c duplicates primal variable v (ref:
    bdd_parallel_mma_base.cpp ``Lagrange_constraint_matrix``, exposed to
    Python by bdd_mp_py.cpp:27). Columns enumerate the valid layers in the
    solver's own flat layer order; rows span all (primal + auxiliary split)
    variables."""
    import scipy.sparse as sp

    f = s.f
    lv = np.asarray(f.layer_var)
    if hasattr(f, "valid_layer_mask"):
        valid = np.asarray(f.valid_layer_mask()).astype(bool)
    else:
        valid = lv < f.nr_vars  # terminal layers carry the sentinel nr_vars
    rows = lv[valid].astype(np.int64)
    cols = np.arange(rows.size, dtype=np.int64)
    return sp.coo_matrix(
        (np.ones(rows.size, dtype=np.float64), (rows, cols)),
        shape=(int(f.nr_vars), int(rows.size)),
    )


def layer_costs_by_key(host, state):
    """(key, lo, hi, def_mm) of the valid layers of a uniform state, flat
    slot order, float64 on the host; key = bdd * (V + 1) + variable, unique
    per layer (``host.layer_bdd`` holds the BDD numbers)."""
    geom = host.geom
    if not host.layer_bdd:
        raise ValueError("the transfer needs layer_bdd bookkeeping")
    V = geom.V
    lbd = np.concatenate([np.asarray(b).ravel() for b in host.layer_bdd]).astype(np.int64)
    lvar = geom.exchange.ids.cpu().numpy()
    m = geom.exchange.valid.cpu().numpy() & (lbd >= 0)
    lo, hi, mm = (x.to(torch.float64).cpu().numpy()[m] for x in state.flat[:3])
    return lbd[m] * (V + 1) + lvar[m], lo, hi, mm


def set_native_costs_by_key(cs, nr_vars: int, key, lo, hi, mm) -> None:
    """Set the native solver's per-layer costs from layers named by
    :func:`layer_costs_by_key`'s key; raises ValueError unless every layer of
    the native solver is among them."""
    cb, cv = cs.layer_info()
    key_c = cb.astype(np.int64) * (nr_vars + 1) + cv.astype(np.int64)
    order = np.argsort(key, kind="stable")
    pos = np.searchsorted(key[order], key_c)
    if pos.size and (pos.max() >= key.size or not (key[order][pos] == key_c).all()):
        raise ValueError("layer sets differ")
    sel = order[pos]
    cs.set_costs(lo[sel], hi[sel], mm[sel])


def transfer_costs_to_native(host, state, cs) -> None:
    """Warm-start the native f64 CPU solver from a uniform-backend state —
    the f32 -> f64 escalation path: run the card at f32 to its precision
    floor, then certify the remaining digits at the reference's default
    double precision (csrc/bdd_host.cpp CpuSolver). Layers are matched by
    their unique (bdd, variable) key; both backends carry the identical
    (lo_cost, hi_cost, deferred mm) per-layer semantics (oracle-verified).

    ``host``: UniformHost with layer_bdd bookkeeping (any flattener output);
    ``state``: its UniformState; ``cs``: NativeCpuSolver over the SAME
    collection (same bdd numbering)."""
    set_native_costs_by_key(cs, host.geom.V, *layer_costs_by_key(host, state))


# ----------------------------------------------------------- exact solve
def exact_min_via_meld(
    collection,
    objective,
    max_nodes: int = 2_000_000,
    pair_cap: int = 30_000_000,
):
    """Exact ILP optimum by melding ALL constraints into ONE BDD.

    With a single BDD the Lagrange decomposition has no duality gap, so the
    min-cost root-to-TOP path of the full conjunction IS the exact optimum —
    the framework-native substitute for the reference's Gurobi exact-solve
    hooks (src/specialized_solvers/solve_easy_variables.py hands its reduced
    core to Gurobi; callers here hand it to this). Exponential in general:
    melds run pairwise (a pairwise product is bounded by the size product,
    so each step is predictable) and abort once ``max_nodes`` total or a
    ``pair_cap`` product bound is exceeded. Returns (optimum, assignment
    [len(objective)]) or None (too large); raises on an infeasible model.
    """
    from bdd_tpu_torch.bdd.collection import (
        BOT,
        TOP,
        BddCollection,
        is_terminal,
    )

    obj = np.asarray(objective, dtype=np.float64)
    cur = collection
    # meld neighbors in VARIABLE order: conjoining BDDs with overlapping
    # supports keeps the product near the instance's pathwidth; random
    # pairing measured 5-50x larger intermediates on chain-like families
    alive = sorted(
        range(cur.nr_bdds()),
        key=lambda b: (min(cur.variables(b)), max(cur.variables(b))),
    )
    zeros = [0] * obj.shape[0]
    while len(alive) > 1:
        nxt = BddCollection()
        for k in range(0, len(alive), 2):
            pair = alive[k : k + 2]
            if len(pair) == 2:
                na = cur.nr_bdd_nodes(pair[0])
                nb = cur.nr_bdd_nodes(pair[1])
                if na * nb > pair_cap:
                    return None
            try:
                cur.bdd_and(pair, out=nxt)
            except ValueError:
                # the conjunction collapsed to a terminal: constant, so its
                # value anywhere decides which — TOP (pair redundant given
                # reduction, drop it) or BOT (model infeasible)
                if all(cur.evaluate(p, zeros) for p in pair):
                    continue
                raise ValueError(
                    "infeasible model (melded conjunction is BOT)"
                )
            if nxt.nr_bdd_nodes() > max_nodes:
                return None
        if nxt.nr_bdds() == 0:  # everything was redundant: unconstrained
            return (
                float(np.minimum(obj, 0.0).sum()),
                np.where(obj < 0.0, 1, 0).astype(np.int8),
            )
        cur = nxt
        alive = sorted(
            range(cur.nr_bdds()),
            key=lambda b: (min(cur.variables(b)), max(cur.variables(b))),
        )
    b = alive[0]
    s, e = cur.node_range(b)
    support = sorted(set(cur.var[s:e]))
    pos = {v: i for i, v in enumerate(support)}
    sup_arr = np.asarray(support, dtype=np.int64)
    neg = np.minimum(obj[sup_arr], 0.0) if support else np.zeros(0)
    pref = np.concatenate([[0.0], np.cumsum(neg)])
    npos = len(support)

    def cpos(c: int) -> int:
        return npos if is_terminal(c) else pos[cur.var[c]]

    INF = math.inf
    cost = {TOP: 0.0, BOT: INF}
    take_hi: Dict[int, bool] = {}
    for n in range(e - 1, s - 1, -1):
        p = pos[cur.var[n]]
        lo, hi = cur.lo[n], cur.hi[n]
        cl = cost[lo]
        if cl < INF:  # skipped support vars on the arc are free: min(0, c)
            cl = cl + (pref[cpos(lo)] - pref[p + 1])
        ch = cost[hi]
        if ch < INF:
            ch = ch + obj[cur.var[n]] + (pref[cpos(hi)] - pref[p + 1])
        cost[n] = min(cl, ch)
        take_hi[n] = ch < cl
    total = cost[s]
    if total == INF:
        raise ValueError("infeasible model (melded BDD is BOT)")
    # variables outside the support are unconstrained
    free = np.ones(obj.shape[0], dtype=bool)
    free[sup_arr] = False
    total += float(np.minimum(obj[free], 0.0).sum())
    # argmin assignment: walk the chosen path; skipped/free vars take the
    # sign-optimal value
    x = np.where(obj < 0.0, 1, 0).astype(np.int8)
    n = s
    while not is_terminal(n):
        v = cur.var[n]
        hi = take_hi[n]
        x[v] = 1 if hi else 0
        n = cur.hi[n] if hi else cur.lo[n]
    return float(total), x


def exact_min_bruteforce(ilp, max_vars: int = 24, chunk: int = 1 << 18):
    """Vectorized exhaustive optimum for tiny linear 0-1 models (<= max_vars
    variables, singleton monomials): enumerate all assignments in numpy
    chunks. The second exact-solve hook next to exact_min_via_meld — used by
    the primal-quality certificates on reduced cores / companion sizes.
    Returns (optimum, assignment) or None (too large / nonlinear); raises
    on infeasible models."""
    V = ilp.nr_variables()
    if V > max_vars:
        return None
    rows = []
    for c in ilp.constraints_:
        coefs = np.zeros(V)
        for coef, m in zip(c.coefficients, c.monomials):
            if len(m) != 1:
                return None
            coefs[m[0]] += coef
        rows.append((coefs, c.rhs, c.ineq))
    from bdd_tpu_torch.ilp.model import Ineq

    A = np.stack([r[0] for r in rows]) if rows else np.zeros((0, V))
    rhs = np.asarray([r[1] for r in rows], dtype=np.float64)
    ineq = [r[2] for r in rows]
    obj = np.asarray(ilp.objective_[:V], dtype=np.float64)
    best = math.inf
    best_x = None
    total = 1 << V
    bits = np.arange(V, dtype=np.uint64)
    for start in range(0, total, chunk):
        n = min(chunk, total - start)
        idx = np.arange(start, start + n, dtype=np.uint64)
        X = ((idx[:, None] >> bits[None, :]) & 1).astype(np.float64)
        lhs = X @ A.T
        feas = np.ones(n, dtype=bool)
        for j, iq in enumerate(ineq):
            if iq == Ineq.LEQ:
                feas &= lhs[:, j] <= rhs[j] + 1e-9
            elif iq == Ineq.GEQ:
                feas &= lhs[:, j] >= rhs[j] - 1e-9
            else:
                feas &= np.abs(lhs[:, j] - rhs[j]) <= 1e-9
        if not feas.any():
            continue
        vals = X[feas] @ obj
        k = int(np.argmin(vals))
        if vals[k] < best:
            best = float(vals[k])
            best_x = X[feas][k].astype(np.int8)
    if best_x is None:
        raise ValueError("infeasible model")
    return best + float(getattr(ilp, "constant_", 0.0)), best_x
