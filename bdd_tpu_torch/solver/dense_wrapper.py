"""DenseSolver: the object over the dense backend (counterpart of
bdd_tpu/solver/wrapper.py, ``JaxSolver``).

Shares the duck interface of ``RefSolver`` and ``UniformSolver``
(iteration / lower_bound / min_marginals / update_costs / distribute_delta /
...), so the run loop, the host rounding and the outer loops take it. Built
from a ``FlatBdds`` through ``flatten.densify``; the state lives on
``device`` (default the card) in ``dtype``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from bdd_tpu_torch.solver import dense as dn
from bdd_tpu_torch.solver.flatten import DenseBdds, FlatBdds, densify

INF = np.inf


class DenseSolver:
    default_block_size = 10

    def __init__(self, flat: FlatBdds, objective, dtype=torch.float32, device="cuda",
                 omega: float = 0.5, dense: Optional[DenseBdds] = None) -> None:
        self.f = flat
        self.dense = dense if dense is not None else densify(flat)
        self.geom = dn.geom_from_dense(self.dense, dtype=dtype, device=device)
        self.state = dn.init_state(self.geom, self.dense, objective)
        self.omega = omega
        self.dtype = dtype
        self.device = self.geom.device

    # ------------------------------------------------------------------- dual
    def iteration(self) -> None:
        self.state = dn.iteration(self.geom, self.state, self.omega)

    def iteration_block(self, n: int) -> None:
        self.state = dn.iterations(self.geom, self.state, n, self.omega)

    def lower_bound(self) -> float:
        return float(dn.lower_bound_from_cft(self.geom, self.state.cft))

    def lower_bound_with_deferred(self) -> float:
        return float(dn.lower_bound_with_deferred(self.geom, self.state))

    def lower_bound_per_bdd(self) -> np.ndarray:
        per_slot = dn.lower_bound_per_root_slot(self.geom, self.state.cft).cpu().numpy()
        return per_slot[self.dense.root_slot_bdd]

    # -------------------------------------------------------------- marginals
    def min_marginals(self) -> Tuple[np.ndarray, np.ndarray]:
        """Flat [nr_layers] min marginals (m0, m1) in the ``FlatBdds``
        layer order, float64 numpy; +inf at padding."""
        m0d, m1d = dn.min_marginals(self.geom, self.state.lo, self.state.hi, self.state.cft)
        m0 = np.full(self.f.nr_layers, INF)
        m1 = np.full(self.f.nr_layers, INF)
        mask = self.dense.flat_layer_index >= 0
        idx = self.dense.flat_layer_index[mask]
        m0[idx] = m0d.cpu().numpy()[mask]
        m1[idx] = m1d.cpu().numpy()[mask]
        return m0, m1

    def bdds_solution(self) -> torch.Tensor:
        """Per-layer argmin-path choices [H, L] int8, 0 at invalid layers."""
        sol = dn.bdds_solution(self.geom, self.state.lo, self.state.hi)
        return torch.where(self.geom.layer_valid, sol, 0).to(torch.int8)

    # ------------------------------------------------------------------ costs
    def distribute_delta(self) -> None:
        self.state = dn.distribute_delta(self.geom, self.state)

    def _per_var(self, x) -> torch.Tensor:
        x = np.append(np.asarray(x, dtype=np.float64), 0.0)  # the sentinel slot V
        return torch.from_numpy(x).to(self.device, self.dtype)

    def update_costs(self, lo_per_var, hi_per_var) -> None:
        self.state = dn.update_costs(self.geom, self.state, self._per_var(lo_per_var),
                                     self._per_var(hi_per_var))

    def get_flat_costs(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = self.f.nr_layers
        return tuple(self.dense.unpack_costs(x.cpu().numpy(), n)
                     for x in (self.state.lo, self.state.hi, self.state.def_mm))

    def set_flat_costs(self, lo, hi, def_mm=None) -> None:
        def t(x):
            return torch.from_numpy(self.dense.pack_costs(np.asarray(x, np.float64))).to(
                self.device, self.dtype)

        lo_d, hi_d = t(lo), t(hi)
        mm_d = t(def_mm) if def_mm is not None else torch.zeros_like(self.state.def_mm)
        self.state = dn.SolverState(lo=lo_d, hi=hi_d, def_mm=mm_d,
                                    cft=dn.backward_run(self.geom, lo_d, hi_d))


def from_jax_arrays(dense: DenseBdds, state_arrays, dtype=torch.float64,
                    device="cpu") -> dn.SolverState:
    """The JAX package's ``SolverState`` leaves (array-likes ``lo``, ``hi``,
    ``def_mm``, ``cft``, read by attribute or as a 4-sequence) as the port's
    state on ``device``, so that both packages start from the same point.
    ``dense``: the instance's ``DenseBdds``, whose shapes the leaves must
    have; raises ValueError otherwise."""
    leaves = ([getattr(state_arrays, f) for f in dn.SolverState._fields]
              if hasattr(state_arrays, "_fields") else list(state_arrays))
    shapes = [(dense.H, dense.L)] * 3 + [(dense.H, dense.W)]
    if len(leaves) != 4 or any(np.shape(x) != s for x, s in zip(leaves, shapes)):
        raise ValueError(f"state leaves {[np.shape(x) for x in leaves]} do not match the "
                         f"instance's {shapes}")
    dev = torch.device(device)
    return dn.SolverState(*(torch.from_numpy(np.array(x)).to(dev, dtype) for x in leaves))
