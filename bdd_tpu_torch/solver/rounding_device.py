"""On-device incremental rounding for the uniform backend (counterpart of
bdd_tpu/solver/rounding_device.py:28-159).

Semantics of the shared host rounding (bdd_tpu/solver/rounding.py): each
round folds the deferred deltas, computes min marginals, classifies every
variable by the signs of its mm differences (one / zero / equal /
inconsistent) and either returns the mm-argmin solution or perturbs the costs
and reruns a short dual solve. Classification and perturbation stay on the
device; four class counts cross to the host per round. The per-variable
max/min/sum use the deterministic segment reduction of the delta exchange.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from bdd_tpu_torch.solver.rounding import compute_initial_delta, objective_tilt
from bdd_tpu_torch.solver.run import run_solver
from bdd_tpu_torch.utils.logging import bdd_log
from bdd_tpu_torch.solver import uniform as uf

_EPS = 1e-6
_BIGF = 1e9

# draws(V, cur_delta) -> [V] uniform draws in [-cur_delta, cur_delta)
Draws = Callable[[int, float], object]


def _classify(geom: uf.UniformGeom, state: uf.UniformState):
    """(types [V] int8, sum0 [V], sum1 [V], stats [4], solution [V] int8) of
    the delta-distributed state. types: 0 zero, 1 one, 2 equal, 3
    inconsistent; stats counts (one, zero, equal, inconsistent)."""
    s = uf.distribute_delta(geom, state)
    mm = uf.min_marginals_all(geom, s)
    m0 = torch.cat([a.reshape(-1) for a, _ in mm])
    m1 = torch.cat([b.reshape(-1) for _, b in mm])
    lval = geom.exchange.valid
    d = m1 - m0
    d = torch.where(
        torch.isfinite(d), d, torch.where(torch.isfinite(m0), _BIGF, -_BIGF)
    )
    d = torch.where(lval, d, 0.0)
    dmax = uf.segment_reduce(geom, d, "max", -math.inf)
    dmin = uf.segment_reduce(geom, d, "min", math.inf)
    amax = torch.maximum(dmax.abs(), dmin.abs())
    sum0 = uf.segment_reduce(geom, torch.where(lval, m0.clamp(-_BIGF, _BIGF), 0.0), "sum", 0.0)
    sum1 = uf.segment_reduce(geom, torch.where(lval, m1.clamp(-_BIGF, _BIGF), 0.0), "sum", 0.0)
    types = torch.full((geom.V,), 3, dtype=torch.int8, device=geom.device)
    types = torch.where(amax <= _EPS, 2, types).to(torch.int8)
    types = torch.where(dmax < -_EPS, 1, types).to(torch.int8)
    types = torch.where(dmin > _EPS, 0, types).to(torch.int8)
    stats = torch.stack([(types == t).sum() for t in (1, 0, 2, 3)])
    solution = torch.where(
        types == 1, 1, torch.where(types == 0, 0, (sum0 > sum1).to(torch.int8))
    ).to(torch.int8)
    return types, sum0, sum1, stats, solution


def _perturb(geom, state, types, sum0, sum1, r, cur_delta: float, tilt):
    """Apply the perturbation (rounding.py semantics) for the uniform draws
    ``r`` [V] in [-cur_delta, cur_delta). ``tilt`` [V]: objective tilt
    pre-scaled by the bias (zeros: symmetric tie-breaking). The update is
    computed in float64 and cast to the state dtype."""
    if not isinstance(r, torch.Tensor):
        r = torch.from_numpy(np.array(r, dtype=np.float64))
    r = r.to(geom.device, torch.float64)
    r_dir = r + cur_delta * tilt
    mag = r.abs() * cur_delta
    zero = torch.zeros((), dtype=torch.float64, device=geom.device)
    lo_upd = torch.where(
        types == 1,
        cur_delta,
        torch.where((types == 2) & (r_dir < 0), mag,
                    torch.where((types == 3) & (sum0 >= sum1), mag, zero)),
    )
    hi_upd = torch.where(
        types == 0,
        cur_delta,
        torch.where((types == 2) & (r_dir >= 0), mag,
                    torch.where((types == 3) & (sum0 < sum1), mag, zero)),
    )
    lo_u = torch.cat([lo_upd, zero[None]]).to(geom.dtype)
    hi_u = torch.cat([hi_upd, zero[None]]).to(geom.dtype)
    return uf.update_costs_per_var(geom, state, lo_u, hi_u)


def incremental_mm_rounding_device(
    s,
    init_delta: float = math.inf,
    delta_growth_rate: float = 1.1,
    num_itr_lb: int = 100,
    num_rounding_itr: int = 500,
    seed: int = 0,
    verbose: bool = True,
    objective_bias: float = 0.0,
    objective=None,
    draws: Optional[Draws] = None,
) -> Optional[np.ndarray]:
    """Incremental mm-agreement rounding on a port ``UniformSolver``.
    Returns the [V] int8 solution, or None after ``num_rounding_itr``
    rounds. The uniform draws come from a ``torch.Generator`` seeded with
    ``seed`` on the solver's device; ``draws`` replaces them (tests hand in
    another generator's numbers to compare trajectories exactly)."""
    geom = s.geom
    V = geom.V
    if draws is None:
        gen = torch.Generator(device=geom.device)
        gen.manual_seed(seed)

        def draws(n, delta):
            u = torch.rand(n, generator=gen, dtype=torch.float64, device=geom.device)
            return (2.0 * u - 1.0) * delta

    tilt = torch.zeros(V, dtype=torch.float64, device=geom.device)
    if objective_bias > 0.0 and objective is not None:
        tilt = torch.as_tensor(
            objective_bias * objective_tilt(objective, V), device=geom.device
        )
    if math.isinf(init_delta):
        s.distribute_delta()
        m0, m1 = s.min_marginals()
        init_delta = compute_initial_delta(s.f, m0, m1)
    cur_delta = init_delta / delta_growth_rate

    for rnd in range(num_rounding_itr):
        cur_delta = min(cur_delta * delta_growth_rate, 1e6)
        types, sum0, sum1, stats, solution = _classify(geom, s.state)
        n1, n0, neq, ninc = stats.tolist()
        if verbose:
            bdd_log(
                f"[device rounding] round {rnd}, delta {cur_delta:.4g}: "
                f"one {100 * n1 / V:.1f}%, zero {100 * n0 / V:.1f}%, "
                f"equal {100 * neq / V:.1f}%, inconsistent {100 * ninc / V:.1f}%"
            )
        if neq == 0 and ninc == 0:
            if verbose:
                bdd_log("[device rounding] found feasible solution")
            return solution.cpu().numpy()
        r = draws(V, cur_delta)
        s.state = _perturb(geom, s.state, types, sum0, sum1, r, cur_delta, tilt)
        run_solver(
            s,
            max_iter=num_itr_lb,
            tolerance=1e-7,
            improvement_slope=1e-4,
            time_limit=math.inf,
            verbose=False,
            block_size=getattr(s, "default_block_size", 25),
        )
    if verbose:
        bdd_log("[device rounding] no solution found")
    return None
