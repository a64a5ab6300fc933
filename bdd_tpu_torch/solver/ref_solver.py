"""Numpy reference solver over FlatBdds — the semantic oracle.

Implements the FastDOG deferred min-marginal-averaging iteration exactly as the
reference's array-level spec (src/bdd_cuda_torch/bdd_torch_base.py:121-232 and
bdd_torch_learned_mma.py:14-146; CUDA kernels bdd_cuda_parallel_mma.cu:59-346):

  forward sweep over hops:  per-layer min-marginals m0/m1 from cost_from_root
  (current sweep) + cost_from_terminal (previous opposite sweep); remove
  omega*(m1-m0) from the costlier side; add back the alpha-weighted share of the
  per-variable deferred delta; propagate cost_from_root with updated costs.
  Deferred mm differences accumulate per primal variable into delta (segment
  sum of relu(+-mm)) consumed by the next half-sweep.

This backend is eager numpy (scatter via np.minimum.at), used as the test
oracle for the JAX/Pallas backends and for tiny host-side solves.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from bdd_tpu_torch.solver.flatten import FlatBdds

INF = np.inf


def _hop_cost_update(lo, hi, m0, m1, omega, alpha, din_lo, din_hi):
    """Shared MMA cost update for one hop's layers.

    Semantics of the reference CPU parallel MMA (bdd_parallel_mma_base.cpp:
    844-887): with both min-marginal sides finite, remove omega*(m1-m0) from
    the costlier side; an infinite side forces that side's cost to +inf and is
    recorded as an infinite deferred mm (so the per-variable delta becomes +inf
    and the forcing propagates to all other BDDs of the variable on the next
    half-sweep). The alpha-weighted delta from the previous half-sweep is
    always added back.

    Returns (new_lo, new_hi, def_mm). def_mm encoding: finite omega*(m1-m0)
    when both sides finite; -inf when m0 = inf (variable forced to 1); +inf
    when m1 = inf (forced to 0).
    """
    fin0 = np.isfinite(m0)
    fin1 = np.isfinite(m1)
    both = fin0 & fin1
    with np.errstate(invalid="ignore"):
        diff = np.where(both, m1 - m0, 0.0)
    mm_rm = omega * diff
    new_lo = np.where(fin0, lo - np.maximum(-mm_rm, 0.0), INF) + alpha * din_lo
    new_hi = np.where(fin1, hi - np.maximum(mm_rm, 0.0), INF) + alpha * din_hi
    def_mm = np.where(both, mm_rm, np.where(fin1, -INF, INF))
    return new_lo, new_hi, def_mm



def numpy_forward_run(f, lo: np.ndarray, hi: np.ndarray, dtype) -> np.ndarray:
    """Hop-major shortest-path costs from the roots (the SINGLE numpy sweep
    implementation — RefSolver and SequentialSolver both route here)."""
    cfr = np.full(f.nr_nodes, INF, dtype=dtype)
    cfr[f.root_node] = 0.0
    for h in range(f.nr_hops):
        s, e = f.hop_node_range(h)
        lmap = f.node_to_layer[s:e]
        np.minimum.at(cfr, f.lo_node[s:e], cfr[s:e] + lo[lmap])
        np.minimum.at(cfr, f.hi_node[s:e], cfr[s:e] + hi[lmap])
    return cfr


def numpy_backward_run(f, lo: np.ndarray, hi: np.ndarray, dtype) -> np.ndarray:
    """Hop-major shortest-path costs to TOP (single numpy implementation)."""
    cft = np.zeros(f.nr_nodes, dtype=dtype)
    cft[f.bot_node] = INF
    for h in range(f.nr_hops - 1, -1, -1):
        s, e = f.hop_node_range(h)
        lmap = f.node_to_layer[s:e]
        cft[s:e] = np.minimum(
            cft[f.lo_node[s:e]] + lo[lmap], cft[f.hi_node[s:e]] + hi[lmap]
        )
    return cft


class RefSolver:
    def __init__(
        self,
        flat: FlatBdds,
        objective=None,
        dtype=np.float64,
    ) -> None:
        self.f = flat
        self.dtype = dtype
        if objective is not None:
            self.lo_cost, self.hi_cost = flat.init_costs(objective, dtype)
        else:
            self.lo_cost = np.zeros(flat.nr_layers, dtype=dtype)
            self.hi_cost = np.zeros(flat.nr_layers, dtype=dtype)
        self.def_mm = np.zeros(flat.nr_layers, dtype=dtype)
        self._cft: Optional[np.ndarray] = None  # cost_from_terminal cache

    # ------------------------------------------------------------------ sweeps
    def _init_cfr(self) -> np.ndarray:
        cfr = np.full(self.f.nr_nodes, INF, dtype=self.dtype)
        cfr[self.f.root_node] = 0.0
        return cfr

    def _init_cft(self) -> np.ndarray:
        cft = np.zeros(self.f.nr_nodes, dtype=self.dtype)
        cft[self.f.bot_node] = INF
        return cft

    def forward_run(
        self, lo_cost: Optional[np.ndarray] = None, hi_cost: Optional[np.ndarray] = None
    ) -> np.ndarray:
        lo = self.lo_cost if lo_cost is None else lo_cost
        hi = self.hi_cost if hi_cost is None else hi_cost
        return numpy_forward_run(self.f, lo, hi, self.dtype)

    def backward_run(
        self, lo_cost: Optional[np.ndarray] = None, hi_cost: Optional[np.ndarray] = None
    ) -> np.ndarray:
        lo = self.lo_cost if lo_cost is None else lo_cost
        hi = self.hi_cost if hi_cost is None else hi_cost
        return numpy_backward_run(self.f, lo, hi, self.dtype)

    def lower_bound(self) -> float:
        cft = self.backward_run()
        self._cft = cft
        return float(np.sum(cft[self.f.root_node]))

    def lower_bound_per_bdd(self) -> np.ndarray:
        cft = self.backward_run()
        return cft[self.f.root_node].copy()

    # -------------------------------------------------------------- marginals
    def min_marginals(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-layer min marginals (m0, m1): minimal path cost with the layer's
        variable set to 0 / 1 (terminal layers: inf)."""
        f = self.f
        cfr = self.forward_run()
        cft = self.backward_run()
        m0 = np.full(f.nr_layers, INF, dtype=self.dtype)
        m1 = np.full(f.nr_layers, INF, dtype=self.dtype)
        for h in range(f.nr_hops):
            s, e = f.hop_node_range(h)
            lmap = f.node_to_layer[s:e]
            lo_path = cfr[s:e] + self.lo_cost[lmap] + cft[f.lo_node[s:e]]
            hi_path = cfr[s:e] + self.hi_cost[lmap] + cft[f.hi_node[s:e]]
            np.minimum.at(m0, lmap, lo_path)
            np.minimum.at(m1, lmap, hi_path)
        return m0, m1

    # -------------------------------------------------------------- iteration
    def _compute_delta(self, def_mm: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        f = self.f
        valid = f.valid_layer_mask()
        v = f.layer_var[valid]
        mm = def_mm[valid]
        delta_lo = np.zeros(f.nr_vars, dtype=self.dtype)
        delta_hi = np.zeros(f.nr_vars, dtype=self.dtype)
        np.add.at(delta_lo, v, np.maximum(-mm, 0.0))
        np.add.at(delta_hi, v, np.maximum(mm, 0.0))
        return delta_lo, delta_hi

    def _isotropic_alpha(self) -> np.ndarray:
        f = self.f
        alpha = np.zeros(f.nr_layers, dtype=self.dtype)
        valid = f.valid_layer_mask()
        alpha[valid] = 1.0 / f.num_bdds_per_var[f.layer_var[valid]]
        return alpha

    def forward_iteration(
        self,
        alpha: np.ndarray,
        omega,
        cft: np.ndarray,
    ) -> np.ndarray:
        """One forward half-iteration in place; returns new cost_from_root.

        ``omega`` may be a scalar or per-layer array."""
        f = self.f
        delta_lo, delta_hi = self._compute_delta(self.def_mm)
        cfr = self._init_cfr()
        new_lo = self.lo_cost.copy()
        new_hi = self.hi_cost.copy()
        new_mm = np.zeros_like(self.def_mm)
        omega_arr = np.broadcast_to(np.asarray(omega, dtype=self.dtype), (f.nr_layers,))
        for h in range(f.nr_hops):
            s, e = f.hop_node_range(h)
            ls, le = f.hop_layer_range(h)
            lmap = f.node_to_layer[s:e]
            # min marginals of this hop
            m0 = np.full(le - ls, INF, dtype=self.dtype)
            m1 = np.full(le - ls, INF, dtype=self.dtype)
            lo_path = cfr[s:e] + self.lo_cost[lmap] + cft[f.lo_node[s:e]]
            hi_path = cfr[s:e] + self.hi_cost[lmap] + cft[f.hi_node[s:e]]
            np.minimum.at(m0, lmap - ls, lo_path)
            np.minimum.at(m1, lmap - ls, hi_path)
            new_lo[ls:le], new_hi[ls:le], new_mm[ls:le] = _hop_cost_update(
                self.lo_cost[ls:le],
                self.hi_cost[ls:le],
                m0,
                m1,
                omega_arr[ls:le],
                alpha[ls:le],
                delta_lo[f.layer_var[ls:le]],
                delta_hi[f.layer_var[ls:le]],
            )
            # propagate with updated costs
            np.minimum.at(cfr, f.lo_node[s:e], cfr[s:e] + new_lo[lmap])
            np.minimum.at(cfr, f.hi_node[s:e], cfr[s:e] + new_hi[lmap])
        self.lo_cost, self.hi_cost, self.def_mm = new_lo, new_hi, new_mm
        return cfr

    def backward_iteration(
        self,
        alpha: np.ndarray,
        omega,
        cfr: np.ndarray,
    ) -> np.ndarray:
        f = self.f
        delta_lo, delta_hi = self._compute_delta(self.def_mm)
        cft = self._init_cft()
        new_lo = self.lo_cost.copy()
        new_hi = self.hi_cost.copy()
        new_mm = np.zeros_like(self.def_mm)
        omega_arr = np.broadcast_to(np.asarray(omega, dtype=self.dtype), (f.nr_layers,))
        for h in range(f.nr_hops - 1, -1, -1):
            s, e = f.hop_node_range(h)
            ls, le = f.hop_layer_range(h)
            lmap = f.node_to_layer[s:e]
            m0 = np.full(le - ls, INF, dtype=self.dtype)
            m1 = np.full(le - ls, INF, dtype=self.dtype)
            lo_path = cfr[s:e] + self.lo_cost[lmap] + cft[f.lo_node[s:e]]
            hi_path = cfr[s:e] + self.hi_cost[lmap] + cft[f.hi_node[s:e]]
            np.minimum.at(m0, lmap - ls, lo_path)
            np.minimum.at(m1, lmap - ls, hi_path)
            new_lo[ls:le], new_hi[ls:le], new_mm[ls:le] = _hop_cost_update(
                self.lo_cost[ls:le],
                self.hi_cost[ls:le],
                m0,
                m1,
                omega_arr[ls:le],
                alpha[ls:le],
                delta_lo[f.layer_var[ls:le]],
                delta_hi[f.layer_var[ls:le]],
            )
            cft[s:e] = np.minimum(
                cft[f.lo_node[s:e]] + new_lo[lmap],
                cft[f.hi_node[s:e]] + new_hi[lmap],
            )
        self.lo_cost, self.hi_cost, self.def_mm = new_lo, new_hi, new_mm
        self._cft = cft
        return cft

    def iteration(self, omega: float = 0.5, alpha: Optional[np.ndarray] = None) -> None:
        """One full dual iteration (forward + backward half-sweeps).
        (ref: bdd_cuda_parallel_mma.cu:142-153 with isotropic alpha)"""
        if alpha is None:
            alpha = self._isotropic_alpha()
        if self._cft is None:
            self._cft = self.backward_run()
        cfr = self.forward_iteration(alpha, omega, self._cft)
        self.backward_iteration(alpha, omega, cfr)

    def iterations(self, n: int, omega: float = 0.5) -> float:
        for _ in range(n):
            self.iteration(omega)
        return self.lower_bound_with_deferred()

    # ------------------------------------------------------- deferred handling
    def distribute_delta(self) -> None:
        """Fold deferred mm differences back into the costs so that
        (lo_cost, hi_cost) is a valid dual point (ref: bdd_cuda_base.cu:1397-1437)."""
        f = self.f
        delta_lo, delta_hi = self._compute_delta(self.def_mm)
        alpha = self._isotropic_alpha()
        valid = f.valid_layer_mask()
        lv = f.layer_var[valid]
        self.lo_cost[valid] += alpha[valid] * delta_lo[lv]
        self.hi_cost[valid] += alpha[valid] * delta_hi[lv]
        self.def_mm[:] = 0.0
        self._cft = None

    def lower_bound_with_deferred(self) -> float:
        """Lower bound of the dual point obtained by distributing the deferred
        deltas (without mutating state)."""
        saved = (
            self.lo_cost.copy(), self.hi_cost.copy(), self.def_mm.copy(),
            self._cft,
        )
        self.distribute_delta()
        lb = self.lower_bound()
        self.lo_cost, self.hi_cost, self.def_mm, self._cft = saved
        return lb

    # ------------------------------------------------------------------- misc
    def update_costs(self, delta_lo_vars, delta_hi_vars) -> None:
        """Add per-variable cost deltas, distributed isotropically over layers
        (ref: bdd_cuda_base update_costs)."""
        f = self.f
        dlo = np.asarray(delta_lo_vars, dtype=self.dtype)
        dhi = np.asarray(delta_hi_vars, dtype=self.dtype)
        valid = f.valid_layer_mask()
        lv = f.layer_var[valid]
        scale = 1.0 / f.num_bdds_per_var[lv]
        if dlo.size:
            self.lo_cost[valid] += dlo[lv] * scale
        if dhi.size:
            self.hi_cost[valid] += dhi[lv] * scale
        self._cft = None

    def update_layer_costs(self, lo_delta: np.ndarray, hi_delta: np.ndarray) -> None:
        """Add per-layer cost deltas directly (Wedelin's per-(var,bdd)
        perturbations, ref: wedelin p arrays are layer-indexed)."""
        self.lo_cost += lo_delta
        self.hi_cost += hi_delta
        self._cft = None

    def bdds_solution(self) -> np.ndarray:
        """Per-layer 0/1 argmin path choice per BDD (ref: bdds_solution_cuda,
        bdd_cuda_base.cu:1104-1233). Returns int8 [nr_layers] with -1 for
        terminal layers."""
        f = self.f
        cft = self.backward_run()
        sol = np.full(f.nr_layers, -1, dtype=np.int8)
        active = f.root_node.astype(np.int64)
        for h in range(f.nr_hops):
            s, e = f.hop_node_range(h)
            in_hop = (active >= s) & (active < e)
            idx = active[in_hop]
            lmap = f.node_to_layer[idx]
            lo_val = self.lo_cost[lmap] + cft[f.lo_node[idx]]
            hi_val = self.hi_cost[lmap] + cft[f.hi_node[idx]]
            take_hi = hi_val <= lo_val
            sol[lmap] = take_hi.astype(np.int8)
            nxt = np.where(take_hi, f.hi_node[idx], f.lo_node[idx])
            active[in_hop] = nxt
        return sol

    def solution_per_var(self, sol_per_layer: Optional[np.ndarray] = None) -> np.ndarray:
        """Majority vote of per-BDD solutions per variable (ties -> 1)."""
        f = self.f
        if sol_per_layer is None:
            sol_per_layer = self.bdds_solution()
        valid = f.valid_layer_mask()
        votes = np.zeros(f.nr_vars, dtype=np.int64)
        np.add.at(votes, f.layer_var[valid], sol_per_layer[valid])
        return (2 * votes >= f.num_bdds_per_var).astype(np.int8)
