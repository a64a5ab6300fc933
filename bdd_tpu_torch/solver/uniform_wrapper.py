"""UniformSolver — object wrapper for the bucketed uniform backend
(counterpart of bdd_tpu/solver/uniform_wrapper.py).

Duck-compatible with the solvers that ``bdd_tpu_torch.solver.run.run_solver``
and ``bdd_tpu_torch.solver.rounding`` drive: iteration / iteration_block /
lower_bound / min_marginals / distribute_delta / update_costs and ``.f``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.solver.layout import UniformHost, flatten_uniform


class UniformLayerView:
    """The layer-indexed view the host rounding helpers read: numpy arrays
    over the concatenated per-bucket [H*B] layers."""

    def __init__(self, host: UniformHost) -> None:
        geom = host.geom
        self.host = host
        self.nr_vars = host.nr_vars
        self.nr_primal_vars = host.nr_primal_vars
        self.layer_var = np.concatenate(
            [g.layer_var.cpu().numpy().ravel() for g in geom.buckets]
        ).astype(np.int32)
        self._valid = geom.exchange.valid.cpu().numpy()
        self.num_bdds_per_var = geom.num_bdds_per_var.cpu().numpy()

    def valid_layer_mask(self) -> np.ndarray:
        return self._valid


class UniformSolver:
    default_block_size = 25

    def __init__(self, host: UniformHost, objective, omega: float = 0.5,
                 layer_costs=None) -> None:
        """``layer_costs``: optional {(bdd, var): (lo, hi)} warm start, the
        tightening cost transfer; ``objective`` is not read then (the
        transferred duals carry the whole decomposition)."""
        self.host = host
        self.geom = host.geom
        self.dtype = host.geom.dtype
        self.device = host.geom.device
        if layer_costs is not None:
            self.state = uf.init_uniform_state_from_layer_costs(host, layer_costs)
        else:
            self.state = uf.init_uniform_state(host, objective)
        self.omega = omega
        self.f = UniformLayerView(host)

    @classmethod
    def from_collection(cls, collection, nr_vars: int, objective,
                        nr_primal_vars: Optional[int] = None, dtype=torch.float32,
                        device="cuda", **kwargs) -> "UniformSolver":
        """The Python pipeline's constructor: flatten a ``BddCollection`` into
        the bucketed layout on ``device`` (the JAX package's
        ``UniformSolver(collection, ...)``); ``kwargs`` go to the class."""
        host = flatten_uniform(collection, nr_vars, nr_primal_vars, dtype=dtype, device=device)
        return cls(host, objective, **kwargs)

    def _run(self, geom, lo, hi) -> torch.Tensor:
        """The costs-to-terminal the state keeps, refreshed after every cost
        change: the hard backward run (a subclass may keep another)."""
        return uf.backward_run(geom, lo, hi)

    def _hard_cft(self) -> Tuple[torch.Tensor, ...]:
        """Per-bucket hard costs-to-terminal of the current costs: the
        state's own."""
        return self.state.cft

    def export_layer_costs(self) -> dict:
        """Converged duals as {(bdd, var): (lo, hi)}, float64, with the
        deferred ledger distributed first so that the dict carries the whole
        decomposition (the input of ``tighten_collection``'s cost transfer;
        uniform_wrapper.py:84 of the JAX package)."""
        self.distribute_delta()
        lo, hi = (x.to(torch.float64).cpu().numpy() for x in self.state.flat[:2])
        lvar = self.f.layer_var
        lbdd = np.concatenate([np.asarray(b).ravel() for b in self.host.layer_bdd])
        return {(int(lbdd[e]), int(lvar[e])): (lo[e], hi[e])
                for e in np.nonzero(self.f.valid_layer_mask() & (lbdd >= 0))[0]}

    # ------------------------------------------------------------------- dual
    def iteration(self) -> None:
        self.state = uf.iteration(self.geom, self.state, self.omega)

    def iteration_block(self, n: int) -> None:
        self.state = uf.iterations(self.geom, self.state, n, self.omega)

    def lower_bound(self) -> float:
        return float(uf.lower_bound_from_cft(self.geom, self._hard_cft()))

    def lower_bound_with_deferred(self) -> float:
        return float(uf.lower_bound_with_deferred(self.geom, self.state))

    def lower_bound_per_bdd(self) -> np.ndarray:
        """float64 [nr_bdds]: each BDD's root cost (uniform_wrapper.py:115)."""
        out = np.zeros(self.host.nr_bdds)
        for g, cft, lbdd in zip(self.geom.buckets, self._hard_cft(), self.host.layer_bdd):
            roots = g.roots.cpu().numpy()
            vals = cft[:, 0, :].cpu().numpy()
            bdds = np.asarray(lbdd)
            m = roots & (bdds >= 0)
            out[bdds[m]] = vals[m]
        return out

    # -------------------------------------------------------------- marginals
    def min_marginals(self) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenated per-bucket [H*B] min marginals (UniformLayerView
        indexing); +inf at invalid layers."""
        mm = uf.min_marginals_all(self.geom, self.state, self._hard_cft())
        m0 = torch.cat([a.reshape(-1) for a, _ in mm]).cpu().numpy()
        m1 = torch.cat([b.reshape(-1) for _, b in mm]).cpu().numpy()
        return m0, m1

    def bdds_solution(self) -> Tuple[torch.Tensor, ...]:
        """Per-bucket [H, B] int8 argmin-path choices (the L-BFGS and
        subgradient supergradient)."""
        return uf.bdds_solution(self.geom, self.state)

    # ------------------------------------------------------------------ costs
    def distribute_delta(self) -> None:
        self.state = uf.distribute_delta(self.geom, self.state, self._run)

    def update_layer_costs(self, lo_delta, hi_delta) -> None:
        """Per-layer cost deltas in ``UniformLayerView`` (concatenated [H*B])
        indexing, with a fresh costs-to-terminal (uniform_wrapper.py:140-185)."""
        def flat(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=self.device).to(self.dtype)

        self.state = uf.update_costs_flat(self.geom, self.state, flat(lo_delta), flat(hi_delta),
                                          self._run)

    def update_costs(self, lo_per_var, hi_per_var) -> None:
        def per_var(x):
            x = np.append(np.asarray(x, np.float64), 0.0)  # sentinel slot V
            return torch.as_tensor(x, device=self.device).to(self.dtype)

        self.state = uf.update_costs_per_var(
            self.geom, self.state, per_var(lo_per_var), per_var(hi_per_var), self._run
        )
