"""Bucketed uniform dual solver: sweep semantics, delta exchange, iteration.

Port of bdd_tpu/solver/uniform.py:1078-1095 and 1140-1863 to torch ops. The
bucket sweeps and the backward run here are the plain PyTorch versions
("twins") of the CUDA sweep kernels in ``sweep_kernels``: the CPU runs them,
and the card checks the kernels against them. They decode the same geometry
bytes the kernels read (``BucketGeom.decode``). Real IEEE infinities
throughout, as in the XLA scan of the JAX package (not the BIG=1e30 stand-in
of its Pallas kernels).

The iteration keeps every per-layer quantity in one flat tensor over all
buckets (``UniformState.flat``), so a half-sweep is one kernel launch and the
exchange reads and writes flat tensors with no concatenation or split; the
per-bucket form of the state is views of the flat one.

The delta consensus is one deterministic formulation for every dtype and
device: a segment sum over the slots grouped by variable (order fixed once on
the host, ``layout.ExchangeIndex``) and a gather back. It matches the JAX
segment path, the float64 default there; no float atomics, and no wait for
the host (the segment lengths are checked once, when the layout is built).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from bdd_tpu_torch.solver.layout import (
    ARC_BOT,
    ARC_INTERNAL,
    ARC_TOP,
    BucketGeom,
    UniformGeom,
    UniformHost,
    UniformState,
    flatten,
    state_from_flat,
)

INF = float("inf")


# ------------------------------------------------------------ bucket twins
def _restart_cfr(cfr: torch.Tensor, root_row: torch.Tensor, P: int) -> torch.Tensor:
    """Reset restarted columns' frontier to the root initial condition (0 at
    slot 0, INF elsewhere). Exact: the carry entering a restart row is all-INF
    (the previous BDD's last layer has no internal arcs)."""
    root_init = torch.full((P, 1), INF, dtype=cfr.dtype, device=cfr.device)
    # fill_ with a number: an item assignment would copy a device scalar back
    # to the host (one sync a hop)
    root_init[:1].fill_(0.0)
    return torch.where(root_row[None, :], root_init, cfr)


def _child_cft(kind: torch.Tensor, slot: torch.Tensor, cft_next: torch.Tensor, P: int) -> torch.Tensor:
    """cft of the child along one arc type, [..., P, B]: cft_next gathered at
    the arc's slot (0 for a slot >= P), TOP -> 0, BOT -> INF."""
    idx = slot.long()
    gathered = torch.gather(cft_next, -2, idx.clamp_max(P - 1))
    gathered = torch.where(idx < P, gathered, 0.0)
    return torch.where(kind == ARC_TOP, 0.0, torch.where(kind == ARC_BOT, INF, gathered))


def _relax_next(vals, kind, slot, valid, P: int) -> torch.Tensor:
    """Frontier relaxation: next_cfr[k, b] = min over the valid source slots p
    with an internal arc into k of vals[p, b]; INF where no arc arrives. A
    scatter-min by slot: exact in any order, and a NaN among the arrivals
    stays a NaN. No arrival is -0.0: a frontier starts from +0.0 and INF, and
    a sum is -0.0 only if both its terms are."""
    idx = slot.long()
    src = torch.where((kind == ARC_INTERNAL) & valid & (idx < P), vals, INF)
    out = torch.full_like(vals, INF)
    return out.scatter_reduce_(0, idx.clamp_max(P - 1), src, "amin", include_self=True)


class _Relu(torch.autograd.Function):
    """max(x, 0) with ``clamp_min``'s value (the kernels' bits, signed zeros
    included) and the gradient of the JAX package's ``jnp.maximum(x, 0.0)``,
    which splits a tie evenly: 1/2 at x == 0, where ``clamp_min``'s gradient
    is 1. The tie is common: a deferred marginal is 0 wherever a marginal
    difference is 0 or one side is infinite."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp_min(0.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x > 0, g, torch.where(x == 0, 0.5 * g, 0.0))


def relu(x: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    """max(x, 0): ``clamp_min`` (in place if asked) unless autograd records
    x, then :class:`_Relu` (same value, the JAX package's gradient)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Relu.apply(x)
    return x.clamp_min_(0.0) if inplace else x.clamp_min(0.0)


def _hop_cost_update(lo_row, hi_row, m0, m1, omega_row, alpha_row, din_lo, din_hi, lvalid):
    """MMA cost update of one hop row (uniform.py:1181-1205). Forcing deltas
    (±inf) are added unscaled, so alpha <= 1/3 keeps them infinite. The
    double where around alpha * din keeps an infinite delta out of the
    product, whose gradient would be 0 x inf = NaN (the learned path)."""
    fin0 = torch.isfinite(m0)
    fin1 = torch.isfinite(m1)
    both = fin0 & fin1
    diff = torch.where(both, m1 - m0, 0.0)
    diff = torch.where(torch.isnan(diff), 0.0, diff)
    mm_rm = omega_row * diff
    dfin0 = torch.isfinite(din_lo)
    dfin1 = torch.isfinite(din_hi)
    dlo = alpha_row * torch.where(dfin0, din_lo, 0.0) + torch.where(dfin0, 0.0, din_lo)
    dhi = alpha_row * torch.where(dfin1, din_hi, 0.0) + torch.where(dfin1, 0.0, din_hi)
    new_lo = torch.where(fin0, lo_row - relu(-mm_rm), INF) + dlo
    new_hi = torch.where(fin1, hi_row - relu(mm_rm), INF) + dhi
    def_mm = torch.where(both, mm_rm, torch.where(fin1, -INF, INF))
    return (
        torch.where(lvalid, new_lo, 0.0),
        torch.where(lvalid, new_hi, 0.0),
        torch.where(lvalid, def_mm, 0.0),
    )


def _layer_param(x, like: torch.Tensor) -> torch.Tensor:
    """Scalar or [H, B] per-layer parameter as an [H, B] tensor of like's
    dtype (a broadcast view; no copy for scalars)."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).expand(like.shape)


# calls of the plain backward run on a CUDA tensor: what shows that a solve
# on the card took its costs-to-terminal from the kernel's run-only entry
# (``sweep_kernels.backward_run_cuda``) and not from the hop loop below
PLAIN_RUN_CALLS = {"backward_run_cuda": 0}


def bucket_backward_run(g: BucketGeom, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Costs-to-terminal cft [H, P, B] of (lo, hi) (uniform.py:1208): the
    plain version of the ``uniform_backward_run`` entry of the CUDA kernel."""
    if lo.is_cuda:
        PLAIN_RUN_CALLS["backward_run_cuda"] += 1
    P = g.P
    nvalid, lo_k, lo_s, hi_k, hi_s = g.decode()
    cft = torch.empty((g.H, P, g.B), dtype=lo.dtype, device=lo.device)
    cft_next = torch.full((P, g.B), INF, dtype=lo.dtype, device=lo.device)
    for h in range(g.H - 1, -1, -1):
        t_lo = _child_cft(lo_k[h], lo_s[h], cft_next, P)
        t_hi = _child_cft(hi_k[h], hi_s[h], cft_next, P)
        cft_next = torch.where(
            nvalid[h], torch.minimum(lo[h][None] + t_lo, hi[h][None] + t_hi), INF
        )
        cft[h] = cft_next
    return cft


def bucket_forward_run(g: BucketGeom, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Costs-from-root cfr [H, P, B] of (lo, hi) (uniform.py:1226)."""
    P = g.P
    nvalid, lo_k, lo_s, hi_k, hi_s = g.decode()
    roots = g.roots
    cfr = torch.empty((g.H, P, g.B), dtype=lo.dtype, device=lo.device)
    row = torch.where(nvalid[0], 0.0, INF).to(lo.dtype)
    for h in range(g.H):
        if g.packed:
            row = _restart_cfr(row, roots[h], P)
        cfr[h] = row
        row = torch.minimum(
            _relax_next(row + lo[h][None], lo_k[h], lo_s[h], nvalid[h], P),
            _relax_next(row + hi[h][None], hi_k[h], hi_s[h], nvalid[h], P),
        )
    return cfr


def _shift_up(cft: torch.Tensor) -> torch.Tensor:
    """cft of hop h+1 at row h; INF past the last hop."""
    pad = torch.full_like(cft[:1], INF)
    return torch.cat([cft[1:], pad], dim=0)


def bucket_min_marginals(
    g: BucketGeom, lo: torch.Tensor, hi: torch.Tensor, cft: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer min marginals (m0, m1) [H, B]. ``cft``: optional clean
    backward run of (lo, hi); ``state.cft`` always qualifies."""
    P = g.P
    cfr = bucket_forward_run(g, lo, hi)
    if cft is None:
        from bdd_tpu_torch.solver import sweep_kernels as sk

        cft = sk.bucket_backward_run_cuda(g, lo, hi)  # the plain run on CPU tensors
    cft_next = _shift_up(cft)
    nvalid, lo_k, lo_s, hi_k, hi_s = g.decode()
    t_lo = _child_cft(lo_k, lo_s, cft_next, P)
    t_hi = _child_cft(hi_k, hi_s, cft_next, P)
    lo_path = torch.where(nvalid, cfr + lo[:, None, :] + t_lo, INF)
    hi_path = torch.where(nvalid, cfr + hi[:, None, :] + t_hi, INF)
    return lo_path.amin(dim=1), hi_path.amin(dim=1)


# calls of the twin half-sweeps, per direction: what shows that a solve on
# the card went through the kernels and not through these
TWIN_SWEEP_CALLS = {"forward": 0, "backward": 0}


def bucket_forward_iteration(g: BucketGeom, lo, hi, cft, omega, din_lo, din_hi, alpha=None):
    """One forward half-sweep of a bucket (uniform.py:1281-1332): the plain
    version of the ``uniform_forward`` CUDA kernel. din_*: [H, B] gathered
    deltas; ``alpha``/``omega``: scalars or [H, B]; alpha defaults to the
    isotropic 1/#bdds-per-var weights. Returns (lo, hi, def_mm, cfr)."""
    TWIN_SWEEP_CALLS["forward"] += 1
    alpha = _layer_param(g.alpha if alpha is None else alpha, lo)
    omega = _layer_param(omega, lo)
    din_lo = din_lo.to(lo.dtype)
    din_hi = din_hi.to(lo.dtype)
    P = g.P
    cft_next = _shift_up(cft)
    new_lo, new_hi, new_mm = torch.empty_like(lo), torch.empty_like(lo), torch.empty_like(lo)
    cfr = torch.empty_like(cft)
    nv_all, lk_all, ls_all, hk_all, hs_all = g.decode()
    roots, layer_valid = g.roots, g.layer_valid
    row = torch.where(nv_all[0], 0.0, INF).to(lo.dtype)
    for h in range(g.H):
        nvalid = nv_all[h]
        lo_k, lo_s, hi_k, hi_s = lk_all[h], ls_all[h], hk_all[h], hs_all[h]
        if g.packed:
            row = _restart_cfr(row, roots[h], P)
        t_lo = _child_cft(lo_k, lo_s, cft_next[h], P)
        t_hi = _child_cft(hi_k, hi_s, cft_next[h], P)
        m0 = torch.where(nvalid, row + lo[h][None] + t_lo, INF).amin(dim=0)
        m1 = torch.where(nvalid, row + hi[h][None] + t_hi, INF).amin(dim=0)
        nl, nh, mm = _hop_cost_update(
            lo[h], hi[h], m0, m1, omega[h], alpha[h], din_lo[h], din_hi[h], layer_valid[h]
        )
        new_lo[h], new_hi[h], new_mm[h], cfr[h] = nl, nh, mm, row
        row = torch.minimum(
            _relax_next(row + nl[None], lo_k, lo_s, nvalid, P),
            _relax_next(row + nh[None], hi_k, hi_s, nvalid, P),
        )
    return new_lo, new_hi, new_mm, cfr


def bucket_backward_iteration(g: BucketGeom, lo, hi, cfr, omega, din_lo, din_hi, alpha=None):
    """One backward half-sweep of a bucket (uniform.py:1335-1373): the plain
    version of the ``uniform_backward`` CUDA kernel. Reads the forward cfr;
    returns (lo, hi, def_mm, cft)."""
    TWIN_SWEEP_CALLS["backward"] += 1
    alpha = _layer_param(g.alpha if alpha is None else alpha, lo)
    omega = _layer_param(omega, lo)
    din_lo = din_lo.to(lo.dtype)
    din_hi = din_hi.to(lo.dtype)
    P = g.P
    new_lo, new_hi, new_mm = torch.empty_like(lo), torch.empty_like(lo), torch.empty_like(lo)
    cft = torch.empty_like(cfr)
    cft_next = torch.full((P, g.B), INF, dtype=lo.dtype, device=lo.device)
    nv_all, lk_all, ls_all, hk_all, hs_all = g.decode()
    layer_valid = g.layer_valid
    for h in range(g.H - 1, -1, -1):
        nvalid = nv_all[h]
        t_lo = _child_cft(lk_all[h], ls_all[h], cft_next, P)
        t_hi = _child_cft(hk_all[h], hs_all[h], cft_next, P)
        m0 = torch.where(nvalid, cfr[h] + lo[h][None] + t_lo, INF).amin(dim=0)
        m1 = torch.where(nvalid, cfr[h] + hi[h][None] + t_hi, INF).amin(dim=0)
        nl, nh, mm = _hop_cost_update(
            lo[h], hi[h], m0, m1, omega[h], alpha[h], din_lo[h], din_hi[h], layer_valid[h]
        )
        cft_next = torch.where(nvalid, torch.minimum(nl[None] + t_lo, nh[None] + t_hi), INF)
        new_lo[h], new_hi[h], new_mm[h], cft[h] = nl, nh, mm, cft_next
    return new_lo, new_hi, new_mm, cft


TWIN_SWEEPS = (bucket_forward_iteration, bucket_backward_iteration)


# --------------------------------------------------------------- global ops
def segment_reduce(geom: UniformGeom, flat: torch.Tensor, reduce: str, initial: float) -> torch.Tensor:
    """Per-variable reduction [V, ...] of a flat per-slot tensor [E, ...] over
    the valid slots; ``initial`` for variables with no slot. ``unsafe=True``:
    torch would otherwise check ``lengths`` on every call with two copies to
    the host; ``layout._exchange_index`` checked them when it built them. A
    segment is still reduced by one sequential loop in slot order."""
    ex = geom.exchange
    return torch.segment_reduce(
        flat[ex.order], reduce, lengths=ex.lengths, axis=0, unsafe=True, initial=initial
    )


DeltaReduce = Callable[[torch.Tensor], torch.Tensor]


def exchange_delta_flat(geom: UniformGeom, mm: torch.Tensor,
                        delta_reduce: Optional[DeltaReduce] = None):
    """Delta consensus (uniform.py:1571-1609) on the flat slot order: per
    variable, the sums of relu(-mm) and relu(mm) over its layers, gathered
    back to every slot. ``mm`` [E] -> (din_lo, din_hi) [E]; 0 at invalid
    slots. ``delta_reduce``: a callable applied to the per-variable sums
    [V + 1, 2] (row = variable id, the empty row V last) before they are
    gathered back; the hybrid solve adds the host solver's sums there. The
    JAX package also hands it the rows of its permutation exchange, which it
    must map to variables; the port has only this segment exchange, so its
    rows are the variable ids. Every gather is one-dimensional (a gather of
    [E, 2] float64 rows runs several times slower on the card); the reduction
    takes the two columns as one [Ev, 2] tensor, which torch reduces with one
    sequential loop per variable and column (one-dimensional data would go to
    a tree reduction that sums in another order, and slower)."""
    ex = geom.exchange
    m = mm[ex.order]
    contrib = relu(torch.stack([-m, m], dim=1), inplace=True)
    # [V + 1, 2]: the last segment is empty, the sentinel variable V of
    # invalid slots, and comes out as the initial 0
    dsum = torch.segment_reduce(
        contrib, "sum", lengths=ex.segments, axis=0, unsafe=True, initial=0.0
    )
    if delta_reduce is not None:
        dsum = delta_reduce(dsum)
    return dsum[:, 0][ex.ids], dsum[:, 1][ex.ids]


Sweeps = Tuple[Callable, Callable]


def sweep_per_bucket(sweep: Callable, geom: UniformGeom, lo, hi, frontier, omega,
                     din_lo, din_hi, alpha=None) -> Tuple[torch.Tensor, ...]:
    """A half-sweep on flat tensors through a per-bucket sweep function (a
    twin, or a one-bucket kernel wrapper): one call per bucket on views, the
    outputs laid flat again. Same signature from ``geom`` on, and the same
    result, as the one-launch wrappers of ``sweep_kernels``; ``alpha``: flat
    [E] per-layer weights (default ``geom.alpha``)."""
    if isinstance(omega, torch.Tensor) and omega.dim() > 0:
        omegas = geom.per_bucket(omega.expand(geom.plan.E))
    else:
        omegas = (omega,) * len(geom.buckets)
    alphas = (None,) * len(geom.buckets) if alpha is None else geom.per_bucket(alpha)
    outs = [
        sweep(g, l, h, f, om, dl, dh, al)
        for g, l, h, f, om, dl, dh, al in zip(
            geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi),
            geom.per_bucket_nodes(frontier), omegas, geom.per_bucket(din_lo),
            geom.per_bucket(din_hi), alphas)
    ]
    new_lo, new_hi, new_mm, frontiers = zip(*outs)
    return flatten(new_lo), flatten(new_hi), flatten(new_mm), geom.flatten_nodes(frontiers)


def iteration(
    geom: UniformGeom, state: UniformState, omega=0.5, sweeps: Optional[Sweeps] = None,
    delta_reduce=None, alpha=None,
) -> UniformState:
    """One full dual MMA iteration over all buckets on the flat state:
    exchange, forward half-sweep, exchange, backward half-sweep. By default
    each half-sweep is one call of the fused kernel wrappers (one launch on
    the card; the twins bucket by bucket on CPU tensors). ``sweeps``:
    (forward, backward) per-bucket functions to run bucket by bucket
    instead. ``delta_reduce``: the hook of :func:`exchange_delta_flat` for
    both exchanges, or a (forward, backward) pair, one for each. ``omega``:
    a scalar or flat [E] per-layer damping; ``alpha``: flat [E] per-layer
    weights of the deferred deltas (default ``geom.alpha``, the isotropic
    ones; the learned solver passes its own)."""
    if not geom.buckets:
        return state
    if sweeps is None:
        from bdd_tpu_torch.solver import sweep_kernels as sk

        fwd, bwd = sk.forward_iteration_cuda, sk.backward_iteration_cuda
    else:
        fwd, bwd = (functools.partial(sweep_per_bucket, s) for s in sweeps)
    reduce_fwd, reduce_bwd = (delta_reduce if isinstance(delta_reduce, tuple)
                              else (delta_reduce, delta_reduce))
    lo, hi, mm, cft = state.flat
    din_lo, din_hi = exchange_delta_flat(geom, mm, reduce_fwd)
    lo, hi, mm, cfr = fwd(geom, lo, hi, cft, omega, din_lo, din_hi, alpha)
    din_lo, din_hi = exchange_delta_flat(geom, mm, reduce_bwd)
    lo, hi, mm, cft = bwd(geom, lo, hi, cfr, omega, din_lo, din_hi, alpha)
    return state_from_flat(geom, lo, hi, mm, cft)


def iterations(
    geom: UniformGeom, state: UniformState, n: int, omega=0.5, sweeps: Optional[Sweeps] = None,
    delta_reduce=None,
) -> UniformState:
    for _ in range(n):
        state = iteration(geom, state, omega, sweeps, delta_reduce)
    return state


def backward_run(geom: UniformGeom, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Costs-to-terminal cft [N] of flat costs (lo, hi [E]) over all buckets
    (``bucket_backward_run`` of the JAX package, there a scan inside a jitted
    program): on the card one launch per body of the backward kernel's
    run-only entry, on the CPU the plain run bucket by bucket."""
    from bdd_tpu_torch.solver import sweep_kernels as sk

    return sk.backward_run_cuda(geom, lo, hi)


def init_uniform_state(host: UniformHost, objective) -> UniformState:
    """Objective split evenly over each variable's BDDs (hi costs), zero lo
    costs and deferred marginals, clean backward run (uniform.py:1078)."""
    geom = host.geom
    dev, dt = geom.device, geom.dtype
    ex = geom.exchange
    obj = torch.zeros(geom.V + 1, dtype=torch.float64, device=dev)
    obj[: geom.V] = torch.as_tensor(np.asarray(objective, dtype=np.float64), device=dev)
    counts = torch.ones(geom.V + 1, dtype=torch.float64, device=dev)
    counts[: geom.V] = geom.num_bdds_per_var.clamp_min(1)
    share = obj[ex.ids] / counts[ex.ids]  # invalid slots: the sentinel V, 0
    hi = torch.where(ex.valid, share, 0.0).to(dt)
    lo = torch.zeros_like(hi)
    return state_from_flat(geom, lo, hi, torch.zeros_like(hi), backward_run(geom, lo, hi))


def init_uniform_state_from_layer_costs(host: UniformHost, layer_costs) -> UniformState:
    """State from explicit per-layer duals {(bdd, var): (lo, hi)} or (lo, hi,
    mm) triples (uniform.py:1098): the warm start of cut tightening. Missing
    layers get (0, 0) and deferred marginals start at 0 unless a triple gives
    one. ``UniformHost.layer_bdd`` is exact per slot, so packed, wide and huge
    layouts all take it; the costs-to-terminal come from the backward
    kernel's run-only entry."""
    geom = host.geom
    lo, hi, mm = (np.zeros(geom.plan.E) for _ in range(3))
    off = 0
    for g, lbdd in zip(geom.buckets, host.layer_bdd):
        n = g.H * g.B
        lvar = g.layer_var.cpu().numpy().ravel()
        lbdd = np.asarray(lbdd).ravel()
        for e in np.nonzero(g.layer_valid.cpu().numpy().ravel() & (lbdd >= 0))[0]:
            c = layer_costs.get((int(lbdd[e]), int(lvar[e])))
            if c is not None:
                lo[off + e], hi[off + e] = c[0], c[1]
                if len(c) > 2:
                    mm[off + e] = c[2]
        off += n

    def t(x):
        return torch.from_numpy(x).to(geom.device, geom.dtype)

    lo, hi = t(lo), t(hi)
    return state_from_flat(geom, lo, hi, t(mm), backward_run(geom, lo, hi))


def lower_bound_from_cft(geom: UniformGeom, cft: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of per-BDD root costs (slot 0 at every root row), accumulated in
    float64 and cast back to the state dtype (uniform.py:1675)."""
    lb = torch.zeros((), dtype=torch.float64, device=geom.device)
    for g, c in zip(geom.buckets, cft):
        lb = lb + torch.where(g.roots, c[:, 0, :], 0.0).to(torch.float64).sum()
    return lb.to(geom.dtype)


def folded_costs(geom: UniformGeom, state: UniformState,
                 delta_reduce: Optional[DeltaReduce] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flat costs (lo, hi) with the deferred marginals folded in
    (``delta_reduce``: as in :func:`exchange_delta_flat`)."""
    lo, hi, mm, _ = state.flat
    din_lo, din_hi = exchange_delta_flat(geom, mm, delta_reduce)
    valid = geom.exchange.valid
    return (torch.where(valid, lo + geom.alpha * din_lo, 0.0),
            torch.where(valid, hi + geom.alpha * din_hi, 0.0))


def distribute_delta(geom: UniformGeom, state: UniformState, run=backward_run,
                     delta_reduce: Optional[DeltaReduce] = None) -> UniformState:
    """Fold the deferred marginals into the costs (uniform.py:1707); ``run``
    (geom, lo, hi) -> cft [N] refreshes the costs-to-terminal (the smooth
    solver passes its smooth run); ``delta_reduce``: as in
    :func:`exchange_delta_flat`."""
    nl, nh = folded_costs(geom, state, delta_reduce)
    return state_from_flat(geom, nl, nh, torch.zeros_like(nl), run(geom, nl, nh))


def lower_bound(geom: UniformGeom, state: UniformState) -> torch.Tensor:
    return lower_bound_from_cft(geom, state.cft)


def lower_bound_with_deferred(geom: UniformGeom, state: UniformState,
                              delta_reduce: Optional[DeltaReduce] = None) -> torch.Tensor:
    return lower_bound_from_cft(geom, distribute_delta(geom, state, delta_reduce=delta_reduce).cft)


def min_marginals_all(geom: UniformGeom, state: UniformState, cft=None):
    """Per-bucket hard min-marginals of the state's costs; ``cft``: per-bucket
    hard costs-to-terminal in place of the state's own."""
    return tuple(
        bucket_min_marginals(g, lo, hi, c)
        for g, lo, hi, c in zip(geom.buckets, state.lo, state.hi,
                                state.cft if cft is None else cft)
    )


def update_costs_flat(geom: UniformGeom, state: UniformState, lo_delta: torch.Tensor,
                      hi_delta: torch.Tensor, run=backward_run) -> UniformState:
    """Add per-slot cost deltas [E] at the valid slots, refreshing the
    costs-to-terminal with ``run`` (as in :func:`distribute_delta`)."""
    lo, hi, mm, _ = state.flat
    valid = geom.exchange.valid
    nl = torch.where(valid, lo + lo_delta, 0.0)
    nh = torch.where(valid, hi + hi_delta, 0.0)
    return state_from_flat(geom, nl, nh, mm, run(geom, nl, nh))


def update_costs_per_var(
    geom: UniformGeom, state: UniformState, lo_u: torch.Tensor, hi_u: torch.Tensor,
    run=backward_run,
) -> UniformState:
    """Add per-variable cost deltas [V+1] (sentinel last) split by the
    isotropic weights, refreshing the costs-to-terminal (uniform.py:1784)."""
    ids = geom.exchange.ids
    return update_costs_flat(geom, state, geom.alpha * lo_u[ids], geom.alpha * hi_u[ids], run)


# --------------------------------------------------- solutions & dual algebra
# What the outer loops (L-BFGS, subgradient) need. Per-layer vectors are flat
# [E] tensors over all buckets, as the state is: one torch.dot is an inner
# product over the whole dual.
def bdds_solution(geom: UniformGeom, state: UniformState) -> Tuple[torch.Tensor, ...]:
    """Per-layer 0/1 argmin-path choices, per bucket [H, B] int8
    (uniform.py:1745): every bucket advances all its BDDs' path pointers one
    hop a step; ties take the hi arc. The active slot's arcs are gathered by
    index (the JAX package picks them with a one-hot mask)."""
    out = []
    for g, lo, hi, cft in zip(geom.buckets, state.lo, state.hi, state.cft):
        P = g.P
        nvalid, lo_k, lo_s, hi_k, hi_s = g.decode()
        cft_next = _shift_up(cft)
        active = torch.zeros((1, g.B), dtype=torch.int64, device=lo.device)  # root slot 0
        sol = torch.empty((g.H, g.B), dtype=torch.int8, device=lo.device)
        for h in range(g.H):
            def pick(x):
                return x.gather(0, active)[0]

            def child(kind, slot):  # cft of the active node's child along one arc
                k, s_ = pick(kind), pick(slot).long()
                t = cft_next[h].gather(0, s_.clamp_max(P - 1)[None])[0]
                t = torch.where(s_ < P, t, 0.0)
                t = torch.where(k == ARC_TOP, 0.0, torch.where(k == ARC_BOT, INF, t))
                return k, s_, torch.where(pick(nvalid[h]), t, INF)

            k_lo, s_lo, t_lo = child(lo_k[h], lo_s[h])
            k_hi, s_hi, t_hi = child(hi_k[h], hi_s[h])
            take_hi = hi[h] + t_hi <= lo[h] + t_lo
            kind = torch.where(take_hi, k_hi, k_lo)
            nxt = torch.where(take_hi, s_hi, s_lo)
            active = torch.where(kind == ARC_INTERNAL, nxt, 0)[None]
            sol[h] = take_hi
        out.append(torch.where(g.layer_valid, sol, 0).to(torch.int8))
    return tuple(out)


def net_solver_costs(geom: UniformGeom, state: UniformState,
                     delta_reduce: Optional[DeltaReduce] = None) -> torch.Tensor:
    """Per-layer net costs x = hi - lo + deferred share, flat [E]
    (uniform.py:1803); ``delta_reduce``: as in :func:`exchange_delta_flat`
    (the sharded solve sums the deltas across its ranks there)."""
    lo, hi, mm, _ = state.flat
    dl, dh = exchange_delta_flat(geom, mm, delta_reduce)
    fl, fh = torch.isfinite(dl), torch.isfinite(dh)
    # a variable forced BOTH ways (infeasible) has dl = dh = +inf; inf - inf
    # would put a NaN into the L-BFGS history: the deferred share counts as 0
    # (the run loop stops on the infinite lower bound)
    diff = torch.where(fl & fh, dh - dl,
                       torch.where(fl, INF, torch.where(fh, -INF, 0.0)))
    return torch.where(geom.exchange.valid, hi - lo + geom.alpha * diff, 0.0)


def make_dual_feasible(geom: UniformGeom, g: torch.Tensor,
                       sum_reduce: Optional[DeltaReduce] = None) -> torch.Tensor:
    """Zero-sum projection per primal variable of a flat per-layer vector [E]
    (uniform.py:1828): the per-variable sums by the deterministic segment
    reduction of the exchange; the sentinel variable V of invalid slots is
    the empty last segment, 0. ``sum_reduce``: a callable applied to the
    per-variable sums [V + 1] before they are gathered back (the sharded
    solve sums them across its ranks)."""
    ex = geom.exchange
    x = torch.where(ex.valid, g, 0.0)
    sums = torch.segment_reduce(
        x[ex.order].unsqueeze(1), "sum", lengths=ex.segments, axis=0, unsafe=True, initial=0.0
    )[:, 0]
    if sum_reduce is not None:
        sums = sum_reduce(sums)
    return torch.where(ex.valid, g - geom.alpha * sums[ex.ids], 0.0)


def gradient_step(geom: UniformGeom, state: UniformState, g: torch.Tensor, step_size) -> UniformState:
    """hi += step * g for a flat per-layer vector g [E], with a fresh
    backward run (uniform.py:1856)."""
    lo, hi, mm, _ = state.flat
    nh = hi + torch.where(geom.exchange.valid, step_size * g, 0.0)
    return state_from_flat(geom, lo, nh, mm, backward_run(geom, lo, nh))
