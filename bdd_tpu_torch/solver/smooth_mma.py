"""Smoothed dual-ascent MMA (sum-marginal averaging) on the uniform layout.

Port of bdd_tpu/solver/smooth_mma.py to torch ops on the flat state. The
reference's smoothed parallel solver
(include/bdd_solver/bdd_parallel_mma_base_smooth.h:286-560) runs the SAME
deferred-averaging iteration as hard MMA with min-marginals replaced by
temperature-T smoothed sum-marginals: per layer, m_x = -T log sum over paths
of exp(-path_x / T); the update removes omega * relu(m0 - m1) from lo (resp.
omega * relu(m1 - m0) from hi), defers the removed amount into the
per-variable delta and adds back the averaged delta of the previous
half-sweep. Costs stay unscaled and the log-sum-exp carries the temperature,
so annealing T needs no cost rescaling.

The smoothed dual bound, the sum over BDDs of -T log Z_root, lower-bounds
the hard MMA bound and converges to it as T -> 0. At a fixed T it ascends
only nearly: the update is hard MMA's relu split applied to smoothed
marginals (the reference comments its strict-monotonicity asserts out), and
on grid12 from the initial point it rises for a few iterations and then falls
towards its fixed point, in the JAX package as here.

The JAX package runs these half-sweeps as XLA scans (it has no Pallas kernel
for them), so here they are hop loops of torch ops on the state's device;
the exchange between them is the hard solver's (``exchange_delta_flat``).
The hard bound and the hard costs-to-terminal come from the backward
kernel's run-only entry (``uniform.backward_run``); nothing here calls the
hard twins. A kernel for the smooth half-sweeps is queued in ROADMAP.md.

Wired to the JSON config as relaxation solver "smooth mma" with the keys
  "smoothing": initial temperature (reference key, bdd_solver.cpp:127),
  "smoothing decay factor" / "min smoothing": annealing schedule, applied
  once per termination-check block.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.solver.layout import (
    BucketGeom,
    UniformGeom,
    UniformHost,
    UniformState,
    flatten,
    state_from_flat,
)
from bdd_tpu_torch.solver.smooth import (
    _smin,
    _smin2,
    _srelax,
    _temperature,
    bucket_smooth_backward_run,
    bucket_sum_marginals,
)
from bdd_tpu_torch.solver.uniform import INF, _child_cft, _hop_cost_update, _restart_cfr, _shift_up
from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver


def bucket_smooth_forward_iteration(g: BucketGeom, lo, hi, cft, omega, din_lo, din_hi,
                                    smoothing, alpha=None):
    """One smoothed forward half-sweep of a bucket (forward_sm semantics,
    bdd_parallel_mma_base_smooth.h:368-485). ``cft`` must be a SMOOTH
    backward run of (lo, hi). Returns (lo, hi, def_mm, cfr)."""
    alpha = uf._layer_param(g.alpha if alpha is None else alpha, lo)
    omega = uf._layer_param(omega, lo)
    din_lo, din_hi = din_lo.to(lo.dtype), din_hi.to(lo.dtype)
    P = g.P
    T = _temperature(smoothing, g, lo)[None]
    cft_next = _shift_up(cft)
    nv_all, lk_all, ls_all, hk_all, hs_all = g.decode()
    roots, layer_valid = g.roots, g.layer_valid
    new_lo, new_hi, new_mm = torch.empty_like(lo), torch.empty_like(lo), torch.empty_like(lo)
    cfr = torch.empty_like(cft)
    row = torch.where(nv_all[0], 0.0, INF).to(lo.dtype)
    for h in range(g.H):
        nvalid, lo_k, lo_s, hi_k, hi_s = nv_all[h], lk_all[h], ls_all[h], hk_all[h], hs_all[h]
        if g.packed:
            row = _restart_cfr(row, roots[h], P)
        t_lo = _child_cft(lo_k, lo_s, cft_next[h], P)
        t_hi = _child_cft(hi_k, hi_s, cft_next[h], P)
        m0 = _smin(torch.where(nvalid, row + lo[h][None] + t_lo, INF), 0, T)
        m1 = _smin(torch.where(nvalid, row + hi[h][None] + t_hi, INF), 0, T)
        nl, nh, mm = _hop_cost_update(lo[h], hi[h], m0, m1, omega[h], alpha[h], din_lo[h],
                                      din_hi[h], layer_valid[h])
        new_lo[h], new_hi[h], new_mm[h], cfr[h] = nl, nh, mm, row
        row = _srelax(row + nl[None], row + nh[None], lo_k, lo_s, hi_k, hi_s, nvalid, P, T)
    return new_lo, new_hi, new_mm, cfr


def bucket_smooth_backward_iteration(g: BucketGeom, lo, hi, cfr, omega, din_lo, din_hi,
                                     smoothing, alpha=None):
    """Smoothed backward half-sweep (backward_sm,
    bdd_parallel_mma_base_smooth.h:488-560). ``cfr`` from the preceding
    smoothed forward half-sweep. Returns (lo, hi, def_mm, cft)."""
    alpha = uf._layer_param(g.alpha if alpha is None else alpha, lo)
    omega = uf._layer_param(omega, lo)
    din_lo, din_hi = din_lo.to(lo.dtype), din_hi.to(lo.dtype)
    P = g.P
    T = _temperature(smoothing, g, lo)[None]
    nv_all, lk_all, ls_all, hk_all, hs_all = g.decode()
    layer_valid = g.layer_valid
    new_lo, new_hi, new_mm = torch.empty_like(lo), torch.empty_like(lo), torch.empty_like(lo)
    cft = torch.empty_like(cfr)
    cft_next = torch.full((P, g.B), INF, dtype=lo.dtype, device=lo.device)
    for h in range(g.H - 1, -1, -1):
        nvalid = nv_all[h]
        t_lo = _child_cft(lk_all[h], ls_all[h], cft_next, P)
        t_hi = _child_cft(hk_all[h], hs_all[h], cft_next, P)
        m0 = _smin(torch.where(nvalid, cfr[h] + lo[h][None] + t_lo, INF), 0, T)
        m1 = _smin(torch.where(nvalid, cfr[h] + hi[h][None] + t_hi, INF), 0, T)
        nl, nh, mm = _hop_cost_update(lo[h], hi[h], m0, m1, omega[h], alpha[h], din_lo[h],
                                      din_hi[h], layer_valid[h])
        cft_next = torch.where(nvalid, _smin2(nl[None] + t_lo, nh[None] + t_hi, T), INF)
        new_lo[h], new_hi[h], new_mm[h], cft[h] = nl, nh, mm, cft_next
    return new_lo, new_hi, new_mm, cft


def _sweep(sweep, geom: UniformGeom, lo, hi, frontier, omega, din_lo, din_hi, smoothing):
    """A smoothed half-sweep on flat tensors, bucket by bucket on views; the
    outputs laid flat again (the frontier in storage order)."""
    outs = [
        sweep(g, l, h, f, omega, dl, dh, smoothing)
        for g, l, h, f, dl, dh in zip(
            geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi),
            geom.per_bucket_nodes(frontier), geom.per_bucket(din_lo), geom.per_bucket(din_hi))
    ]
    new_lo, new_hi, new_mm, frontiers = zip(*outs)
    return flatten(new_lo), flatten(new_hi), flatten(new_mm), geom.flatten_nodes(frontiers)


def smooth_iteration(geom: UniformGeom, state: UniformState, omega, smoothing) -> UniformState:
    """One full smoothed dual iteration: exchange, forward half-sweep,
    exchange, backward half-sweep (iterate(), _smooth.h:286-348). The
    state's cft holds SMOOTH backward runs."""
    if not geom.buckets:
        return state
    lo, hi, mm, cft = state.flat
    din_lo, din_hi = uf.exchange_delta_flat(geom, mm)
    lo, hi, mm, cfr = _sweep(bucket_smooth_forward_iteration, geom, lo, hi, cft, omega,
                             din_lo, din_hi, smoothing)
    din_lo, din_hi = uf.exchange_delta_flat(geom, mm)
    lo, hi, mm, cft = _sweep(bucket_smooth_backward_iteration, geom, lo, hi, cfr, omega,
                             din_lo, din_hi, smoothing)
    return state_from_flat(geom, lo, hi, mm, cft)


def smooth_iterations(geom: UniformGeom, state: UniformState, n: int, omega,
                      smoothing) -> UniformState:
    for _ in range(n):
        state = smooth_iteration(geom, state, omega, smoothing)
    return state


def smooth_backward_all(geom: UniformGeom, lo, hi, smoothing) -> torch.Tensor:
    """Smoothed costs-to-terminal of flat costs (lo, hi [E]) -> flat [N]."""
    return geom.flatten_nodes([
        bucket_smooth_backward_run(g, l, h, smoothing)
        for g, l, h in zip(geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))
    ])


def smooth_lower_bound_from_cft(geom: UniformGeom, cft) -> torch.Tensor:
    """Sum over BDDs of smoothed root costs (compute_smooth_lower_bound_after_
    backward_pass, _smooth.h:150-172), accumulated in float64: <= the hard
    bound of the same costs. ``cft``: per-bucket [H, P, B] (``state.cft``)."""
    lb = torch.zeros((), dtype=torch.float64, device=geom.device)
    for g, c in zip(geom.buckets, cft):
        lb = lb + torch.where(g.roots, c[:, 0, :], 0.0).to(torch.float64).sum()
    return lb.to(geom.dtype)


def _smooth_run(smoothing):
    def run(geom: UniformGeom, lo, hi) -> torch.Tensor:
        return smooth_backward_all(geom, lo, hi, smoothing)
    return run


def smooth_distribute_delta(geom: UniformGeom, state: UniformState, smoothing) -> UniformState:
    """Fold the deferred deltas into the costs; refresh the SMOOTH cft."""
    return uf.distribute_delta(geom, state, _smooth_run(smoothing))


def smooth_lower_bound_with_deferred(geom: UniformGeom, state: UniformState,
                                     smoothing) -> torch.Tensor:
    return smooth_lower_bound_from_cft(geom, smooth_distribute_delta(geom, state, smoothing).cft)


class SmoothSolver(UniformSolver):
    """Smoothed dual solver: ``UniformSolver`` (run loop, rounding, cost
    updates) whose state keeps the SMOOTH costs-to-terminal, with geometric
    temperature annealing once per iteration block.

    ``lower_bound*``, ``lower_bound_per_bdd`` and ``min_marginals`` read the
    HARD costs-to-terminal of the current costs, a fresh run of the backward
    kernel's run-only entry (always a valid dual bound; the smoothed one is
    ``smooth_bound()``), so the run loop's termination criteria are the
    reference's."""

    def __init__(self, host: UniformHost, objective, omega: float = 0.5,
                 smoothing: float = 0.1, smoothing_decay: float = 0.5,
                 min_smoothing: float = 1e-3) -> None:
        # Annealing (measured on grid 6x6x3 by the JAX package): the iteration
        # converges to a fixed point at every fixed T, but that point's HARD
        # bound degrades quickly with T, so runs start at a moderate T and
        # anneal towards min_smoothing, where the trajectory meets hard MMA.
        super().__init__(host, objective, omega)
        self.smoothing = float(smoothing)
        self.smoothing_decay = float(smoothing_decay)
        self.min_smoothing = float(min_smoothing)
        self._refresh()  # the smooth cft in place of the hard one

    def _run(self, geom, lo, hi) -> torch.Tensor:
        return smooth_backward_all(geom, lo, hi, self.smoothing)

    def _hard_cft(self) -> Tuple[torch.Tensor, ...]:
        lo, hi = self.state.flat[:2]
        return self.geom.per_bucket_nodes(uf.backward_run(self.geom, lo, hi))

    def _refresh(self) -> None:
        lo, hi, mm, _ = self.state.flat
        self.state = state_from_flat(self.geom, lo, hi, mm, self._run(self.geom, lo, hi))

    # ------------------------------------------------------------------- dual
    def iteration(self) -> None:
        self.state = smooth_iteration(self.geom, self.state, self.omega, self.smoothing)

    def iteration_block(self, n: int) -> None:
        self.state = smooth_iterations(self.geom, self.state, n, self.omega, self.smoothing)
        # anneal once per block; refresh the smooth cft at the new temperature
        new_T = max(self.smoothing * self.smoothing_decay, self.min_smoothing)
        if new_T != self.smoothing:
            self.smoothing = new_T
            self._refresh()

    def smooth_bound(self) -> float:
        return float(smooth_lower_bound_with_deferred(self.geom, self.state, self.smoothing))

    def sum_marginals(self) -> Tuple[np.ndarray, np.ndarray]:
        mm = [bucket_sum_marginals(g, lo, hi, self.smoothing)
              for g, lo, hi in zip(self.geom.buckets, self.state.lo, self.state.hi)]
        m0 = torch.cat([a.reshape(-1) for a, _ in mm]).cpu().numpy()
        m1 = torch.cat([b.reshape(-1) for _, b in mm]).cpu().numpy()
        return m0, m1
