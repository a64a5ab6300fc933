"""Smooth (log-sum-exp) sweeps and sum marginals on the uniform layout.

Port of bdd_tpu/solver/smooth.py to torch ops on the flat state. Every min
of the min-plus sweeps becomes

    smin_T(x) = -T * log(sum exp(-x / T))

which lower-bounds the hard min and converges to it as T -> 0: smoothed
lower bounds, sum marginals and soft solutions (a sigmoid of marginal
differences), and the features of the learned solver.

The JAX package runs these sweeps as XLA scans and has no Pallas kernel for
them; here they are hop loops of torch ops on the state's device (on the
card when the solver is on the card). The frontier relaxation is a scatter
log-sum-exp by slot (a scatter-max, a gather, a scatter-add) and not the JAX
package's dense [P, 2P, B] candidate matrix, so any width P takes it; both
sum the same terms (a candidate that does not arrive contributes exp(-inf)
= 0, or makes a row of no finite arrival +inf either way).

Temperature ``smoothing`` is a scalar or a per-column vector [B] per bucket,
as in the JAX package. With packed columns several BDDs share a column, so a
per-column temperature applies to all of them; per-BDD temperatures need an
unpacked host (``flatten_uniform(pack=False)``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from bdd_tpu_torch.solver.layout import ARC_INTERNAL, BucketGeom, UniformGeom, UniformState
from bdd_tpu_torch.solver.uniform import INF, _child_cft, _restart_cfr, _shift_up

_BIG = 1e30  # stand-in of +inf inside a log-sum-exp (masked lanes carry +inf)


def _smin(x: torch.Tensor, axis: int, T) -> torch.Tensor:
    """-T * logsumexp(-x / T) along ``axis``; inf-safe: a non-finite entry
    counts as _BIG, and a result of no finite entry is +inf."""
    neg = -torch.where(torch.isfinite(x), x, _BIG)
    m = neg.amax(dim=axis, keepdim=True)
    out = m + T * torch.log(torch.exp((neg - m) / T).sum(dim=axis, keepdim=True))
    out = -out.squeeze(axis)
    return torch.where(out >= _BIG / 2, INF, out)


def _smin2(a: torch.Tensor, b: torch.Tensor, T) -> torch.Tensor:
    """Smoothed elementwise minimum of two tensors."""
    na = -torch.where(torch.isfinite(a), a, _BIG)
    nb = -torch.where(torch.isfinite(b), b, _BIG)
    m = torch.maximum(na, nb)
    out = -(m + T * torch.log(torch.exp((na - m) / T) + torch.exp((nb - m) / T)))
    return torch.where(out >= _BIG / 2, INF, out)


def _srelax(vals_lo, vals_hi, lo_k, lo_s, hi_k, hi_s, nvalid, P: int, T) -> torch.Tensor:
    """Smoothed frontier relaxation of one hop, [P, B]: per target slot k,
    smin_T over the valid source slots with an internal arc into k of their
    value along that arc; +inf where no finite value arrives."""
    idx = torch.cat([lo_s, hi_s]).long()
    arrive = torch.cat([(lo_k == ARC_INTERNAL), (hi_k == ARC_INTERNAL)]) & nvalid.repeat(2, 1)
    src = torch.where(arrive & (idx < P), torch.cat([vals_lo, vals_hi]), INF)
    idx = idx.clamp_max(P - 1)
    neg = -torch.where(torch.isfinite(src), src, _BIG)
    m = torch.full_like(vals_lo, -_BIG).scatter_reduce_(0, idx, neg, "amax", include_self=True)
    s = torch.zeros_like(vals_lo).scatter_add_(0, idx, torch.exp((neg - m.gather(0, idx)) / T))
    out = -(m + T * torch.log(s))
    return torch.where(out >= _BIG / 2, INF, out)


def _temperature(smoothing, g: BucketGeom, like: torch.Tensor) -> torch.Tensor:
    """The temperature of a bucket as a [B] tensor of like's dtype. A number
    is filled in on the device: a copy of it from the host would wait for
    the card (the learned solver's rollout reads its features with no host
    sync)."""
    if isinstance(smoothing, (int, float)):
        return torch.full((g.B,), smoothing, dtype=like.dtype, device=like.device)
    return torch.as_tensor(smoothing, dtype=like.dtype, device=like.device).expand(g.B)


def bucket_smooth_backward_run(g: BucketGeom, lo: torch.Tensor, hi: torch.Tensor,
                               smoothing) -> torch.Tensor:
    """Smoothed costs-to-terminal, [H, P, B]."""
    P = g.P
    T = _temperature(smoothing, g, lo)[None]
    nvalid, lo_k, lo_s, hi_k, hi_s = g.decode()
    cft = torch.empty((g.H, P, g.B), dtype=lo.dtype, device=lo.device)
    cft_next = torch.full((P, g.B), INF, dtype=lo.dtype, device=lo.device)
    for h in range(g.H - 1, -1, -1):
        t_lo = _child_cft(lo_k[h], lo_s[h], cft_next, P)
        t_hi = _child_cft(hi_k[h], hi_s[h], cft_next, P)
        cft_next = torch.where(nvalid[h], _smin2(lo[h][None] + t_lo, hi[h][None] + t_hi, T), INF)
        cft[h] = cft_next
    return cft


def bucket_smooth_forward_run(g: BucketGeom, lo: torch.Tensor, hi: torch.Tensor,
                              smoothing) -> torch.Tensor:
    """Smoothed costs-from-root, [H, P, B]."""
    P = g.P
    T = _temperature(smoothing, g, lo)[None]
    nvalid, lo_k, lo_s, hi_k, hi_s = g.decode()
    roots = g.roots
    cfr = torch.empty((g.H, P, g.B), dtype=lo.dtype, device=lo.device)
    row = torch.where(nvalid[0], 0.0, INF).to(lo.dtype)
    for h in range(g.H):
        if g.packed:
            # exact: the carry entering a restart row is all +inf
            row = _restart_cfr(row, roots[h], P)
        cfr[h] = row
        row = _srelax(row + lo[h][None], row + hi[h][None], lo_k[h], lo_s[h], hi_k[h], hi_s[h],
                      nvalid[h], P, T)
    return cfr


def bucket_sum_marginals(g: BucketGeom, lo: torch.Tensor, hi: torch.Tensor,
                         smoothing) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smoothed per-layer marginals (m0, m1) [H, B] (ref: sum_marginals,
    bdd_branch_instruction_smooth.h:226-283), all hops at once."""
    P = g.P
    T = _temperature(smoothing, g, lo)[None]
    cfr = bucket_smooth_forward_run(g, lo, hi, smoothing)
    cft_next = _shift_up(bucket_smooth_backward_run(g, lo, hi, smoothing))
    nvalid, lo_k, lo_s, hi_k, hi_s = g.decode()
    t_lo = _child_cft(lo_k, lo_s, cft_next, P)
    t_hi = _child_cft(hi_k, hi_s, cft_next, P)
    lo_path = torch.where(nvalid, cfr + lo[:, None, :] + t_lo, INF)
    hi_path = torch.where(nvalid, cfr + hi[:, None, :] + t_hi, INF)
    return _smin(lo_path, 1, T), _smin(hi_path, 1, T)


def smooth_lower_bound(geom: UniformGeom, state: UniformState, smoothing) -> torch.Tensor:
    """Smoothed dual bound: the sum of smoothed per-BDD root costs (<= the
    hard bound), accumulated in float64 and cast to the state's dtype."""
    lb = torch.zeros((), dtype=torch.float64, device=geom.device)
    for g, lo, hi in zip(geom.buckets, state.lo, state.hi):
        cft = bucket_smooth_backward_run(g, lo, hi, smoothing)
        # one root (slot 0) per segment-start row (packed columns hold
        # several BDDs stacked vertically)
        lb = lb + torch.where(g.roots, cft[:, 0, :], 0.0).to(torch.float64).sum()
    return lb.to(geom.dtype)


def smooth_solution(geom: UniformGeom, state: UniformState, smoothing) -> Tuple[torch.Tensor, ...]:
    """Per-layer probability of value 1 per bucket [H, B]: the sigmoid of the
    smoothed marginal difference over T (ref: bdd_torch_base.smooth_solution)."""
    out = []
    for g, lo, hi in zip(geom.buckets, state.lo, state.hi):
        T = torch.clamp_min(_temperature(smoothing, g, lo), 1e-12)
        m0, m1 = bucket_sum_marginals(g, lo, hi, smoothing)
        d = torch.where(torch.isfinite(m0) & torch.isfinite(m1), m0 - m1,
                        torch.where(torch.isfinite(m1), _BIG, -_BIG))
        # Gibbs marginal: m = -T log Z_x, so p(x=1) = sigmoid((m0 - m1) / T)
        out.append(torch.sigmoid(d / T))
    return tuple(out)
