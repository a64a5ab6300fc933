"""Solver-state features of the learned solver.

Port of bdd_tpu/learn/features.py: per-variable, per-subproblem (BDD) and
per-layer (edge) feature tensors of the current solver state, in the flat
slot order of the uniform layout (layers over all buckets, [E]).

Every per-variable and per-BDD sum is a segment reduction over slots grouped
by id once on the host (:class:`Segments`), so it sums in slot order on
every device, as the delta exchange does: no float atomics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from bdd_tpu_torch.solver import learned as ln
from bdd_tpu_torch.solver import smooth as sm
from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.solver.layout import UniformHost, UniformState, flatten

_CLIP = 1e4


@dataclasses.dataclass(frozen=True)
class Segments:
    """Valid slots grouped by an id in [0, n): a segment sum over ``order``
    (the slots sorted stably by id) with ``lengths`` per id."""

    order: torch.Tensor  # int64 [Ev]
    lengths: torch.Tensor  # int64 [n]

    @classmethod
    def build(cls, ids: np.ndarray, valid: np.ndarray, n: int, device) -> "Segments":
        slots = np.nonzero(valid)[0]
        slots = slots[np.argsort(ids[slots], kind="stable")]
        lengths = np.bincount(ids[slots], minlength=n)
        return cls(torch.from_numpy(slots).to(device), torch.from_numpy(lengths).to(device))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Per-id sums [n, ...] of a per-slot tensor [E, ...] over the valid
        slots."""
        return torch.segment_reduce(x[self.order], "sum", lengths=self.lengths, axis=0,
                                    unsafe=True, initial=0.0)


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Static bipartite graph of the ILP: layer e joins variable layer_var[e]
    with BDD layer_bdd[e] (sentinels nr_vars and nr_bdds at padding); flat
    over all buckets. ``coeff`` (per layer), ``rhs`` and ``con_type`` (per
    BDD, LEQ 0 / GEQ 1 / EQ 2) are the static ILP features, None when the
    layout came without a preprocessor. ``root_slots`` / ``root_bdds``: the slot of
    every BDD's root and its number."""

    layer_var: torch.Tensor  # int64 [E]
    layer_bdd: torch.Tensor  # int64 [E]
    layer_valid: torch.Tensor  # bool [E]
    nr_vars: int
    nr_bdds: int
    var_segments: Segments  # nr_vars + 1 segments: the exchange's
    bdd_segments: Segments  # nr_bdds + 1 segments
    root_slots: torch.Tensor  # int64 [R]
    root_bdds: torch.Tensor  # int64 [R]
    coeff: Optional[torch.Tensor] = None  # float32 [E]
    rhs: Optional[torch.Tensor] = None  # float32 [nr_bdds + 1]
    con_type: Optional[torch.Tensor] = None  # float32 [nr_bdds + 1]

    @property
    def E(self) -> int:
        return self.layer_var.shape[0]


def static_ilp_features(host: UniformHost, pre):
    """(coeff [E], rhs [nb + 1], con_type [nb + 1]) from the preprocessor's
    constraints (a ``BddPreprocessor`` or ``utils.batching.BatchedInstances``;
    features.py:48-97). Layers without a recoverable constraint (free-variable
    BDDs, melded groups, split chunks) get zeros."""
    nb = host.nr_bdds
    rhs = np.zeros(nb + 1, np.float64)
    ctype = np.zeros(nb + 1, np.float64)
    coeff_of: dict = {}  # bdd -> {var: coeff}
    ineq_code = {"<=": 0.0, ">=": 1.0, "=": 2.0}

    def add_pre(pre1, var_off, bdd_off):
        cons = list(pre1.ilp.constraints())
        for ci, bdds in enumerate(pre1.ineq_to_bdd_nrs):
            if ci >= len(cons) or len(bdds) != 1:
                continue  # melded group emission rows / dropped constraints
            b = bdds[0] + bdd_off
            c = cons[ci]
            rhs[b] = float(c.rhs)
            ctype[b] = ineq_code.get(getattr(c.ineq, "value", str(c.ineq)), 0.0)
            coeff_of[b] = {m[0] + var_off: float(co)
                           for co, m in zip(c.coefficients, c.monomials) if len(m) == 1}

    if hasattr(pre, "pres"):  # BatchedInstances
        for p, vo, bo in zip(pre.pres, pre.var_offsets, pre.bdd_offsets):
            add_pre(p, vo, bo)
    else:
        add_pre(pre, 0, 0)
    coeffs = []
    for g, lbdd in zip(host.geom.buckets, host.layer_bdd):
        lv = g.layer_var.cpu().numpy().ravel()
        lb = np.asarray(lbdd).ravel()
        coeffs.append(np.array([coeff_of.get(int(b), {}).get(int(v), 0.0)
                                for b, v in zip(lb, lv)], np.float64))
    return np.concatenate(coeffs) if coeffs else np.zeros(0), rhs, ctype


def graph_spec(host: UniformHost, pre=None, static=None) -> GraphSpec:
    """The graph of ``host``; ``pre``: an optional ``BddPreprocessor`` or
    ``BatchedInstances`` giving the static constraint features, or
    ``static``: those features as computed before ((coeff, rhs, con_type)
    numpy arrays, :func:`static_ilp_features`; a dataset's cache)."""
    geom = host.geom
    nb, V = host.nr_bdds, host.nr_vars
    dev = geom.device
    lv, lb, lval, roots = [], [], [], []
    for g, lbdd in zip(geom.buckets, host.layer_bdd):
        valid = g.layer_valid.cpu().numpy()
        bdd = np.asarray(lbdd).astype(np.int64).copy()
        roots.append((g.roots.cpu().numpy() & (bdd >= 0)).ravel())
        bdd[~valid] = nb
        bdd[bdd < 0] = nb
        lv.append(g.layer_var.cpu().numpy().ravel())
        lb.append(bdd.ravel())
        lval.append(valid.ravel())
    cat = (lambda xs, dt: np.concatenate(xs).astype(dt) if xs else np.zeros(0, dt))
    layer_var, layer_bdd = cat(lv, np.int64), cat(lb, np.int64)
    layer_valid, root_mask = cat(lval, bool), cat(roots, bool)
    root_slots = np.nonzero(root_mask)[0]
    if pre is not None:
        static = static_ilp_features(host, pre)
    static = {} if static is None else {
        k: torch.from_numpy(np.asarray(x)).to(dev, torch.float32)
        for k, x in zip(("coeff", "rhs", "con_type"), static)}

    def t(x):
        return torch.from_numpy(x).to(dev)

    return GraphSpec(
        layer_var=t(layer_var), layer_bdd=t(layer_bdd), layer_valid=t(layer_valid),
        nr_vars=V, nr_bdds=nb,
        var_segments=Segments(geom.exchange.order, geom.exchange.segments),
        bdd_segments=Segments.build(layer_bdd, layer_valid, nb + 1, dev),
        root_slots=t(root_slots), root_bdds=t(layer_bdd[root_slots]), **static)


def per_bdd_from_roots(spec: GraphSpec, flat: torch.Tensor) -> torch.Tensor:
    """The values of a flat [E] tensor at the BDD roots as an [nb + 1] vector
    by BDD number (sentinel nb: 0)."""
    out = torch.zeros(spec.nr_bdds + 1, dtype=flat.dtype, device=flat.device)
    return out.index_put((spec.root_bdds,), flat[spec.root_slots])


def per_bdd_lb_vector(host: UniformHost, spec: GraphSpec, state: UniformState) -> torch.Tensor:
    """Per-BDD root costs as an [nr_bdds + 1] vector (sentinel 0)."""
    return per_bdd_from_roots(spec, ln.per_bdd_lower_bound(host.geom, state))


def compute_features(host: UniformHost, spec: GraphSpec, state: UniformState,
                     objective: torch.Tensor, smoothing: float = 1.0, history=None,
                     smooth_temps=(), prev_lb_per_bdd=None):
    """(var_f [V + 1, Fv], bdd_f [nb + 1, Fb], layer_f [E, Fe])
    (features.py:143-256): objective, degrees, costs, min-marginal
    differences, per-BDD bounds, smoothed solutions, the static ILP features
    when the spec has them, the l2-normalized net costs and deferred
    marginals, the argmin solution; ``smooth_temps``: a smoothed solution per
    temperature; ``prev_lb_per_bdd`` [nb + 1]: the previous round's per-BDD
    bounds ('prev_lb', 'lb_change'); ``history``: (sol_avg, lb_fo_avg,
    lb_so_avg) flat [E] from ``learned.learned_iterations_with_stats``."""
    geom = host.geom
    lo, hi, mm_flat, _ = state.flat
    dt = lo.dtype
    valid = spec.layer_valid
    mmdiff = ln.all_min_marginal_differences(geom, state)
    probs = flatten(sm.smooth_solution(geom, state, smoothing))

    def seg_v(x):
        return spec.var_segments.sum(torch.where(valid, x, 0.0))

    def seg_b(x):
        return spec.bdd_segments.sum(torch.where(valid, x, 0.0))

    def c(x):
        return torch.clamp(x, -_CLIP, _CLIP)

    ones = torch.ones_like(lo)
    deg_v, deg_b = seg_v(ones), seg_b(ones)
    obj = torch.cat([objective.to(dt), torch.zeros(1, dtype=dt, device=lo.device)])
    lb_per_bdd = per_bdd_lb_vector(host, spec, state)
    var_f = torch.stack([c(obj), deg_v, c(seg_v(mmdiff)), c(seg_v(probs)), c(seg_v(hi - lo))],
                        dim=-1)
    bdd_cols = [deg_b, c(lb_per_bdd), c(seg_b(mmdiff))]
    layer_cols = [c(lo), c(hi), c(mmdiff), c(probs), valid.to(dt)]
    if spec.coeff is not None:
        layer_cols.append(c(spec.coeff.to(dt)))
        bdd_cols.append(c(spec.rhs.to(dt)))
        bdd_cols.append(spec.con_type.to(dt))
    # the l2-normalized net costs hi - lo + def_mm and deferred marginals;
    # a forced variable's infinite entries count as 0
    raw_net = hi - lo + mm_flat
    net = torch.where(valid & torch.isfinite(raw_net), raw_net, 0.0)
    norm = torch.sqrt(torch.sum(torch.square(c(net)))) + 1e-6
    layer_cols.append(c(net) / norm)
    mm_fin = torch.where(valid & torch.isfinite(mm_flat), mm_flat, 0.0)
    layer_cols.append(c(mm_fin) / norm)
    # the argmin solution: an input feature without a gradient
    sol = flatten(uf.bdds_solution(geom, state)).to(dt)
    layer_cols.append(torch.where(valid, sol, 0.0))
    for T in smooth_temps:
        layer_cols.append(c(flatten(sm.smooth_solution(geom, state, T))))
    if prev_lb_per_bdd is not None:
        bdd_cols.append(c(prev_lb_per_bdd))
        bdd_cols.append(c(lb_per_bdd - prev_lb_per_bdd))
    if history is not None:
        sol_avg, fo_avg, so_avg = history
        layer_cols.append(c(sol_avg))
        bdd_cols.append(c(per_bdd_from_roots(spec, fo_avg)))
        bdd_cols.append(c(per_bdd_from_roots(spec, so_avg)))
    return var_f, torch.stack(bdd_cols, dim=-1), torch.stack(layer_cols, dim=-1)


def split_like(host: UniformHost, flat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-bucket [H, B] views of a flat [E] tensor."""
    return host.geom.per_bucket(flat)
