"""Adaptive subgradient ascent on the Lagrange dual (counterpart of
bdd_tpu/solver/subgradient.py).

Komodakis-style exponential-moving-average step-size control: the
supergradient is the zero-sum-projected per-BDD argmin solution vector; the
step size grows when the EMA of the bound lags the current bound and shrinks
when the bound falls below the best seen. Every step takes its
costs-to-terminal from the run-only entry of the backward kernel
(``uniform.gradient_step``); the host waits for the two lower bounds of an
iteration. On a ``ShardedUniformSolver`` the projection sums across the ranks
and the bounds are global (``lbfgs._Ops``), so every rank steps alike; on a
``DenseSolver`` the dense backend's dual algebra runs instead.
"""
from __future__ import annotations

import math

from bdd_tpu_torch.solver.lbfgs import _Ops
from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver


class SubgradientSolver:
    default_block_size = 1

    EMA_WEIGHT = 0.9
    STEP_INC = 1.1
    STEP_DEC = 0.9

    def __init__(self, base: UniformSolver, step_size: float = 1.0) -> None:
        self.base = base
        self.ops = _Ops(base)
        if hasattr(base, "clock"):  # a sharded base: one clock for all its ranks
            self.clock = base.clock
        self.f = base.f
        self.step_size = step_size
        self.best_lb = -math.inf
        self.ema_lb = -math.inf

    def lower_bound(self) -> float:
        return self.base.lower_bound()

    def lower_bound_with_deferred(self) -> float:
        return self.base.lower_bound_with_deferred()

    def min_marginals(self):
        return self.base.min_marginals()

    def distribute_delta(self) -> None:
        self.base.distribute_delta()

    def update_costs(self, lo_per_var, hi_per_var) -> None:
        self.base.update_costs(lo_per_var, hi_per_var)

    def iteration(self) -> None:
        base = self.base
        lb = base.lower_bound()
        if math.isinf(self.best_lb):
            self.best_lb = lb
        if math.isinf(self.ema_lb):
            self.ema_lb = lb
        self.ops.gradient_step(self.ops.make_dual_feasible(self.ops.grad()), self.step_size)
        lb = base.lower_bound()
        self.best_lb = max(self.best_lb, lb)
        self.ema_lb = self.EMA_WEIGHT * self.ema_lb + (1 - self.EMA_WEIGHT) * lb
        if self.ema_lb < lb:
            self.step_size *= self.STEP_INC
        if lb < self.best_lb:
            self.step_size *= self.STEP_DEC
