"""L-BFGS outer loop maximizing the Lagrange dual (counterpart of
bdd_tpu/solver/lbfgs.py, uniform backend; algorithm of Roetzer et al. 2023):

  x      = per-layer net solver costs (hi - lo + deferred share)
  grad f = per-BDD argmin solutions in {0,1} (a supergradient of the dual)
  history of (s = x_k - x_{k-1}, y = grad_{k-1} - grad_k, rho_inv = s.y),
  curvature skip when rho_inv <= 1e-8; two-loop recursion with initial
  Hessian-diagonal scaling rho_inv_last / |y_last|^2; the direction is
  zero-sum-projected per primal variable (make_dual_feasible) and applied to
  the hi costs with an adaptive step-size search (up to 6 trials, geometric
  decrease on failure / increase on weak success); falls back to plain MMA
  iterations until the history is full or after repeated failures.

The JAX package runs an outer iteration as one jitted program with a
``lax.while_loop`` for the step search, and keeps a host-driven path with the
same control flow, which its tests hold equal to the jitted one. PyTorch runs
eagerly, so this port has the one path: the host control flow
(bdd_tpu/solver/lbfgs.py:479-602). History vectors are flat tensors over all
buckets on the solver's device, as the state is; an inner product is one
``torch.dot``, and the scalars of the two-loop recursion stay on the device.
The host waits for the device where the control flow branches on a value: once
for the curvature s.y of an iteration, and once per step-search trial for its
lower bound. Every gradient step takes its costs-to-terminal from the run-only
entry of the backward kernel (``uniform.gradient_step``).

On a ``ShardedUniformSolver`` (one rank's shard of the dual) the same loop
runs on every rank through :class:`_Ops`: the net costs and the zero-sum
projection sum their per-variable rows across the ranks, and every inner
product is this shard's dot summed across them, so every scalar the host
branches on (a curvature, a trial's bound) is one value that every rank
holds and every rank takes the same branch (bdd_tpu/solver/lbfgs.py:53-110).
On a ``DenseSolver`` (the dense backend) the per-layer vectors are flat
views [H * L] of its [H, L] tensors, and :class:`_Ops` calls the dense
module's dual algebra; there every gradient step takes its costs-to-terminal
from the dense backward run (torch ops).
"""
from __future__ import annotations

import collections
from typing import Deque, NamedTuple, Optional

import torch

from bdd_tpu_torch.solver import dense as dn
from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.solver.dense_wrapper import DenseSolver
from bdd_tpu_torch.solver.layout import flatten
from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver


def solution_gradient(base) -> torch.Tensor:
    """The supergradient of the dual at the solver's state: the per-BDD argmin
    solutions in the state's dtype, 0 at invalid layers; flat [E] over the
    buckets of a uniform base, flat [H * L] over the rows of a dense one."""
    if isinstance(base, DenseSolver):
        return base.bdds_solution().reshape(-1).to(base.dtype)
    return flatten(base.bdds_solution()).to(base.dtype)


class _Ops:
    """The dual algebra of the outer loops on their base solver: one
    device's (``UniformSolver``), one rank's shard of a sharded solve, whose
    ``delta_reduce`` and ``sum_reduce`` sum across the ranks, or the dense
    backend's (``DenseSolver``: flat views of its [H, L] tensors), picked by
    the base's type as the JAX package's ``_Ops`` does (lbfgs.py:53-110)."""

    def __init__(self, base) -> None:
        self.base = base
        self.dense = isinstance(base, DenseSolver)
        self.delta_reduce = getattr(base, "delta_reduce", None)
        self.sum_reduce = getattr(base, "sum_reduce", None)

    def grad(self) -> torch.Tensor:
        return solution_gradient(self.base)

    def net_costs(self) -> torch.Tensor:
        if self.dense:
            return dn.net_solver_costs(self.base.geom, self.base.state).reshape(-1)
        return uf.net_solver_costs(self.base.geom, self.base.state, self.delta_reduce)

    def make_dual_feasible(self, g: torch.Tensor) -> torch.Tensor:
        if self.dense:
            geom = self.base.geom
            return dn.make_dual_feasible(geom, g.reshape(geom.H, geom.L)).reshape(-1)
        return uf.make_dual_feasible(self.base.geom, g, self.sum_reduce)

    def gradient_step(self, g: torch.Tensor, step) -> None:
        if self.dense:
            geom = self.base.geom
            self.base.state = dn.gradient_step(geom, self.base.state, g.reshape(geom.H, geom.L),
                                               step)
        else:
            self.base.state = uf.gradient_step(self.base.geom, self.base.state, g, step)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The inner product over the whole dual (0-dim, on the device)."""
        d = torch.dot(a, b)
        return d if self.sum_reduce is None else self.sum_reduce(d)


class _HistEntry(NamedTuple):
    s: torch.Tensor  # flat [E] (uniform) or [H * L] (dense)
    y: torch.Tensor
    rho_inv: float


class LbfgsSolver:
    """Wraps a ``UniformSolver``, a ``ShardedUniformSolver`` or a
    ``DenseSolver``; duck interface compatible with
    ``run_solver`` and the rounding heuristics (which reach the dual state
    through ``.base``)."""

    # the termination loop checks the bound once per block, at the block
    # length of the JAX package's default path, so both stop after the same
    # iterations
    default_block_size = 10

    def __init__(
        self,
        base: UniformSolver,
        history_size: int = 5,
        init_step_size: float = 1e-6,
        required_relative_lb_increase: float = 1e-6,
        step_size_decrease_factor: float = 0.8,
        step_size_increase_factor: float = 1.1,
    ) -> None:
        self.base = base
        self.ops = _Ops(base)
        if hasattr(base, "clock"):  # a sharded base: one clock for all its ranks
            self.clock = base.clock
        self.f = base.f
        self.m = history_size
        self.step_size = init_step_size
        self.req_rel_lb_increase = required_relative_lb_increase
        self.dec = step_size_decrease_factor
        self.inc = step_size_increase_factor
        self.history: Deque[_HistEntry] = collections.deque()
        self.prev_x: Optional[torch.Tensor] = None
        self.prev_grad: Optional[torch.Tensor] = None
        self.num_unsuccessful = 0
        self.lb_history: list = []

    # ----------------------------------------------------------- base passthru
    def lower_bound(self) -> float:
        return self.base.lower_bound()

    def lower_bound_with_deferred(self) -> float:
        return self.base.lower_bound_with_deferred()

    def min_marginals(self):
        return self.base.min_marginals()

    def distribute_delta(self) -> None:
        self.base.distribute_delta()

    def update_costs(self, lo_per_var, hi_per_var) -> None:
        self._flush()
        self.base.update_costs(lo_per_var, hi_per_var)

    def _flush(self) -> None:
        self.history.clear()
        self.prev_x = None
        self.prev_grad = None
        self.num_unsuccessful = 0

    # -------------------------------------------------------------- lbfgs core
    def _store_iterate(self, cur_grad: torch.Tensor) -> None:
        cur_x = self.ops.net_costs()
        if self.prev_x is not None:
            s = cur_x - self.prev_x
            y = self.prev_grad - cur_grad
            rho_inv = float(self.ops.dot(s, y))  # the curvature decides: one wait
            if rho_inv > 1e-8:
                self.history.append(_HistEntry(s, y, rho_inv))
                if len(self.history) > self.m:
                    self.history.popleft()
        self.prev_x = cur_x
        self.prev_grad = cur_grad

    def _update_possible(self) -> bool:
        return len(self.history) >= self.m and self.num_unsuccessful <= 5

    def _compute_direction(self, cur_grad: torch.Tensor) -> torch.Tensor:
        """Two-loop recursion; gradients negated implicitly by the y
        convention (maximization). The scalars are 0-dim tensors: nothing
        here waits for the device."""
        dot = self.ops.dot
        d = cur_grad
        alphas = []
        for h in reversed(self.history):
            a = dot(h.s, d) / h.rho_inv
            alphas.append(a)
            d = d - a * h.y
        alphas.reverse()
        last = self.history[-1]
        h0 = last.rho_inv / (1e-8 + dot(last.y, last.y))
        # r = H0 * q between the loops (Nocedal alg. 7.4)
        d = h0 * d
        for a, h in zip(alphas, self.history):
            beta = (1.0 / h.rho_inv) * dot(h.y, d)
            d = d + (a - beta) * h.s
        return d

    def _search_step_size_and_apply(self, direction: torch.Tensor) -> None:
        base = self.base
        lb_pre = base.lower_bound()
        if len(self.lb_history) >= self.m:
            past = self.lb_history[-(self.m - 1)] - self.lb_history[-self.m]
        else:
            past = 0.0
        denom = 1e-9 + max(past, 0.0)
        prev_step = 0.0

        def apply(step: float) -> None:
            nonlocal prev_step
            net = step - prev_step
            if net != 0.0:
                self.ops.gradient_step(direction, net)
            prev_step = step

        num_updates = 0
        best_step, best_rel = 0.0, 0.0
        while True:
            apply(self.step_size)
            cur_rel = (base.lower_bound() - lb_pre) / denom  # one wait a trial
            if best_rel < cur_rel:
                best_rel, best_step = cur_rel, self.step_size
            if cur_rel <= 0.0:
                self.step_size *= self.dec
            elif cur_rel < self.req_rel_lb_increase:
                self.step_size *= self.inc
            if num_updates > 5:
                if best_rel > self.req_rel_lb_increase / 10.0:
                    apply(best_step)
                else:
                    apply(0.0)
                    self.num_unsuccessful += 1
                return
            num_updates += 1
            if cur_rel >= self.req_rel_lb_increase:
                break
        if num_updates == 1 and self.num_unsuccessful == 0:
            self.step_size *= self.inc
        self.num_unsuccessful = 0

    # --------------------------------------------------------------- iteration
    def iteration_block(self, n: int) -> None:
        for _ in range(n):
            self.iteration()

    def iteration(self) -> None:
        if self.num_unsuccessful > 5:
            # permanently disabled after repeated failed step searches: plain
            # MMA, without the gradient / net-cost / history machinery
            self.base.iteration()
            return
        if not self.lb_history:
            self.lb_history.append(self.base.lower_bound())
        cur_grad = self.ops.grad()
        self._store_iterate(cur_grad)
        if self._update_possible():
            d = self.ops.make_dual_feasible(self._compute_direction(cur_grad))
            self._search_step_size_and_apply(d)
        self.base.iteration()
        self.lb_history.append(self.base.lower_bound())
