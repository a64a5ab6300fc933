"""Dual-ascent termination loop (ref: include/run_solver_util.h:10-78).

Works with any solver exposing ``iteration()`` and ``lower_bound()`` (the duck
interface of the port's solvers), and reads the solver's ``clock()`` where it
has one (a sharded solver: rank 0's, on every rank). Copy of
bdd_tpu/solver/run.py with the same block schedule, so both packages stop
after the same iterations. Solvers may
expose ``iteration_block(n)`` running n iterations without a host sync; the
loop then checks termination once per block.
"""
from __future__ import annotations

import math
import time

from bdd_tpu_torch.utils.logging import bdd_log, span


def run_solver(
    s,
    max_iter: int = 1000,
    tolerance: float = 1e-6,
    improvement_slope: float = 1e-9,
    time_limit: float = 3600.0,
    verbose: bool = True,
    block_size: int = 1,
    stats: dict = None,
) -> float:
    """Iterate until max_iter / time limit / relative tolerance / improvement
    slope vs first-iteration gain / infeasibility (lb = inf).

    Exact criteria of run_solver_util.h:37-74:
      - |lb_cur - lb_prev| < |tolerance * lb_prev|
      - |lb_cur - lb_prev| < improvement_slope * |lb_initial - lb_first_iter|
    Returns the final lower bound. ``stats``: optional dict filled with
    {iterations, solve_time, initial_lower_bound} (solver statistics for the
    result payload)."""
    assert 0.0 <= improvement_slope < 1.0
    # a sharded solver reads one clock for all its ranks, so that the time
    # limit stops every rank after the same block
    clock = getattr(s, "clock", time.monotonic)
    start = clock()
    lb_initial = s.lower_bound()
    first_gain_per_iter = None  # |lb_initial - lb_after_first_check| / n
    lb_post = lb_initial
    if verbose:
        bdd_log(f"[bdd solver] initial lower bound = {lb_initial:.6f}")
    it = 0
    # Every lower_bound() is a host sync while an enqueued iteration block is
    # nearly free, so the loop doubles the number of blocks between
    # termination checks while the solve is young (the per-iteration criteria
    # below normalize by n). Same schedule as bdd_tpu, for equal trajectories.
    period = 1
    while it < max_iter:
        n = 0
        if block_size > 1 and hasattr(s, "iteration_block"):
            for _ in range(period):
                remaining = max_iter - it
                if remaining <= 0:
                    break
                if remaining < block_size and it > 0:
                    # 'maximum iterations' is an upper bound: stop at the
                    # last full block, as bdd_tpu does (it avoids compiling
                    # a partial block there), so both stop at the same count
                    it = max_iter
                    break
                b = min(block_size, remaining)
                with span("bdd.block"):
                    s.iteration_block(b)
                n += b
                it += b
                if clock() - start > time_limit:
                    break  # bound the overshoot to one block
        else:
            with span("bdd.block"):
                s.iteration()
            n = 1
            it += 1
        if n == 0:
            break
        period = min(period * 2, 8)
        lb_prev = lb_post
        lb_post = s.lower_bound()
        if first_gain_per_iter is None:
            # normalize the baseline PER ITERATION: the first check may sit
            # after a whole block, and using a block's gain as the reference
            # 'first-iteration improvement' (run_solver_util.h:37-74) made
            # the slope criterion ~block_size x looser
            first_gain_per_iter = abs(lb_initial - lb_post) / max(n, 1)
        elapsed = clock() - start
        if verbose:
            bdd_log(
                f"[bdd solver] iteration {it}, lower bound = {lb_post:.6f}, "
                f"time = {elapsed:.3f} s"
            )
        if elapsed > time_limit:
            if verbose:
                bdd_log("[bdd solver] Time limit reached.")
            break
        if math.isinf(lb_post):
            if verbose:
                bdd_log("[bdd solver] problem infeasible")
            break
        if abs(lb_prev - lb_post) < abs(tolerance * lb_prev) * n:
            if verbose:
                bdd_log(f"[bdd solver] Relative progress less than tolerance ({tolerance})")
            break
        if abs(lb_prev - lb_post) < improvement_slope * first_gain_per_iter * n:
            if verbose:
                bdd_log(
                    f"[bdd solver] improvement smaller than {100 * improvement_slope}% "
                    "of initial improvement"
                )
            break
    if verbose:
        bdd_log(f"[bdd solver] final lower bound = {lb_post:.6f}")
    if stats is not None:
        stats.update(
            iterations=it,
            solve_time=round(clock() - start, 4),
            initial_lower_bound=float(lb_initial),
        )
    return lb_post
