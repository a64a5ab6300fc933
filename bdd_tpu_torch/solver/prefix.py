"""Parallel-prefix (log-depth) sweeps on the uniform layout (counterpart of
bdd_tpu/solver/prefix.py).

The plain forward/backward *runs* (no cost updates) are chains of (min,+)
linear maps between consecutive hop frontiers, so they compose associatively:
with the terminal arcs folded into an augmented (P+1)-dimensional transfer
matrix (row = source slot p at hop h, column = destination slot k at hop h+1,
extra column = cheapest TOP-terminal arc, extra absorbing row = the constant)

    M_h[p, k] = cheapest internal arc p -> k
    M_h[p, P] = cheapest terminal arc from p
    M_h[P, :] = [inf, ..., inf, 0]

the suffix (min,+) products give every hop's cost-from-terminal and the prefix
products every hop's cost-from-root in ceil(log2 H) steps of a Hillis-Steele
scan over the hop axis (the JAX package runs ``jax.lax.associative_scan``;
the association order differs, so the two agree within a tolerance, not bit
for bit). Each combine is a small min-plus matrix product over all columns.
Infinities are the JAX package's stand-in 1e30 inside the products and +inf
outside.

Used for lower bounds and min marginals; the MMA *iteration* itself is
sequential along hops (costs update mid-sweep) and keeps the sweep kernels.
The functions take the port's ``BucketGeom`` and decode its arc records
(``BucketGeom.decode``: [H, P, B] for narrow and wide buckets alike) on the
bucket's device, in the dtype of the costs given.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from bdd_tpu_torch.solver.layout import ARC_INTERNAL, ARC_TOP, BucketGeom, UniformGeom, UniformState
from bdd_tpu_torch.solver.uniform import _child_cft

INF = float("inf")
_BIG = 1e30


def _transfer_matrices(g: BucketGeom, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Augmented per-hop transfer matrices [H, P+1(p), P+1(k), B]. A packed
    bucket raises ValueError: its columns would need a restart at each
    segment-start row, but the affine lane P accumulates finished-path costs
    across segments (use an unpacked layout)."""
    if g.packed:
        raise ValueError("prefix sweeps require an unpacked bucket layout")
    P, B, H = g.P, g.B, g.H
    nvalid, lo_k, lo_s, hi_k, hi_s = g.decode()
    iota_k = torch.arange(P, device=lo.device).view(1, 1, P, 1)

    def arc_block(kind, slot, cost_row):
        # [H, P(p), P(k), B]
        m = ((slot.long()[:, :, None, :] == iota_k)
             & (kind[:, :, None, :] == ARC_INTERNAL) & nvalid[:, :, None, :])
        return torch.where(m, cost_row[:, None, None, :], _BIG)

    A = torch.minimum(arc_block(lo_k, lo_s, lo), arc_block(hi_k, hi_s, hi))
    t_lo = torch.where((lo_k == ARC_TOP) & nvalid, lo[:, None, :], _BIG)
    t_hi = torch.where((hi_k == ARC_TOP) & nvalid, hi[:, None, :], _BIG)
    right_col = torch.minimum(t_lo, t_hi)[:, :, None, :]  # [H, P, 1, B]
    bottom = torch.full((H, 1, P + 1, B), _BIG, dtype=lo.dtype, device=lo.device)
    bottom[:, :, P, :] = 0.0
    return torch.cat([torch.cat([A, right_col], dim=2), bottom], dim=1)  # [H, P+1, P+1, B]


def _minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(min,+) product contracting a's column index with b's row index:
    (a (x) b)[p, j] = min_k a[p, k] + b[k, j]; shapes [..., p, k, B]."""
    return torch.clamp_max(a[..., :, :, None, :] + b[..., None, :, :, :], _BIG).amin(dim=-3)


def _scan(M: torch.Tensor, combine: Callable, reverse: bool) -> torch.Tensor:
    """Inclusive scan over the hop axis in ceil(log2 H) steps (Hillis-Steele):
    out[h] = M[0] (x) ... (x) M[h] forward, M[h] (x) ... (x) M[H-1] reverse,
    ``combine(earlier, later)`` associative."""
    out = M
    step, H = 1, M.shape[0]
    while step < H:
        nxt = out.clone()
        if reverse:
            nxt[:H - step] = combine(out[:H - step], out[step:])
        else:
            nxt[step:] = combine(out[:H - step], out[step:])
        out = nxt
        step *= 2
    return out


def bucket_backward_run_prefix(g: BucketGeom, lo: torch.Tensor, hi: torch.Tensor,
                               M=None) -> torch.Tensor:
    """cost-from-terminal for every hop, [H, P, B], via suffix products
    S_h = M_h (x) M_{h+1} (x) ... (x) M_{H-1}; cft_h = S_h[:, P] (last col)."""
    if M is None:
        M = _transfer_matrices(g, lo, hi)
    S = _scan(M, _minplus, reverse=True)
    cft = S[:, :g.P, g.P, :]
    return torch.where(cft >= _BIG / 2, INF, cft)


def bucket_forward_run_prefix(g: BucketGeom, lo: torch.Tensor, hi: torch.Tensor,
                              M=None) -> torch.Tensor:
    """cost-from-root for every hop, [H, P, B]: cfr as a row vector,
    cfr_{h+1} = cfr_0 (x) (M_0 (x) ... (x) M_h)."""
    if M is None:
        M = _transfer_matrices(g, lo, hi)
    P = g.P
    prefix = _scan(M, _minplus, reverse=False)  # [H, P+1, P+1, B]
    cfr0 = torch.where(g.node_valid[0], 0.0, _BIG).to(lo.dtype)
    cfr0_aug = torch.cat([cfr0, torch.full((1, g.B), _BIG, dtype=lo.dtype, device=lo.device)])
    # row-vector application: out[h, k] = min_p cfr0_aug[p] + prefix[h, p, k]
    applied = torch.clamp_max(prefix + cfr0_aug[None, :, None, :], _BIG).amin(dim=1)
    cfr = torch.cat([cfr0[None], applied[:-1, :P, :]], dim=0)
    return torch.where(cfr >= _BIG / 2, INF, cfr)


def lower_bound_prefix(geom: UniformGeom, state: UniformState) -> torch.Tensor:
    """The sum of the BDDs' root costs from the log-depth backward runs,
    accumulated in float64 and cast to the state's dtype (0-dim)."""
    lb = torch.zeros((), dtype=torch.float64, device=geom.device)
    for g, lo, hi in zip(geom.buckets, state.lo, state.hi):
        root = bucket_backward_run_prefix(g, lo, hi)[0, 0, :]
        lb = lb + torch.where(g.layer_valid[0], root, 0.0).to(torch.float64).sum()
    return lb.to(geom.dtype)


def bucket_min_marginals_prefix(g: BucketGeom, lo: torch.Tensor,
                                hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer min marginals [H, B] via the two log-depth sweeps (one shared
    transfer-matrix build: it is the dominant O(H*P^2*B) term); all hops at
    once, as the JAX package's ``vmap``."""
    P = g.P
    M = _transfer_matrices(g, lo, hi)
    cfr = bucket_forward_run_prefix(g, lo, hi, M=M)
    cft = bucket_backward_run_prefix(g, lo, hi, M=M)
    cft_next = torch.cat([cft[1:], torch.full((1, P, g.B), INF, dtype=lo.dtype,
                                              device=lo.device)], dim=0)
    nvalid, lo_k, lo_s, hi_k, hi_s = g.decode()
    t_lo = _child_cft(lo_k, lo_s, cft_next, P)
    t_hi = _child_cft(hi_k, hi_s, cft_next, P)
    lo_path = torch.where(nvalid, cfr + lo[:, None, :] + t_lo, INF)
    hi_path = torch.where(nvalid, cfr + hi[:, None, :] + t_hi, INF)
    return lo_path.amin(dim=1), hi_path.amin(dim=1)
