"""The dense hop-scan backend in torch ops (counterpart of
bdd_tpu/solver/jax_solver.py).

Every BDD node at hop distance h forms row h of static [H, W] node arrays;
every (BDD, variable) layer at hop h a slot of row h of [H, L] layer arrays.
Terminal arcs carry flags (TOP: cost-from-terminal 0, BOT: +inf) instead of
pointers. The JAX package runs the sweeps as ``lax.scan``s over the rows;
here they are Python loops over the H hops, each hop a few torch ops on
whole rows, as the port's twins are. Names and semantics follow the JAX
module one for one, so a reader finds each counterpart.

Determinism without atomics on float sums:
- the frontier relaxation (``jax.ops.segment_min``) is a ``scatter_reduce_``
  with "amin" into W + 1 slots; padding and terminal arcs go to slot W, which
  is dropped. A minimum is exact in any order;
- every per-variable sum (``compute_delta``, ``make_dual_feasible``, the
  sharded solve's local sums) is a ``torch.segment_reduce`` over the valid
  layers sorted by variable, an order fixed once on the host when the
  geometry is built (the scheme of ``uniform.exchange_delta_flat``).
So two float32 runs on the card give the same bits, and nothing in an
iteration waits for the host.

The cost update of a hop is the port's own ``uniform._hop_cost_update``, as
the JAX module calls the JAX package's.

Geometry build happens on the host in numpy; tensors go to ``device`` once,
with ``dtype`` the float type of the solve.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.solver.flatten import ARC_BOT, ARC_INTERNAL, ARC_TOP, DenseBdds
from bdd_tpu_torch.solver.layout import check_lengths, resolve_device

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class DenseGeom:
    """Static BDD geometry on the device. Nodes [H, W], layers [H, L].

    The first ten fields are those of the JAX package's ``DenseGeom`` (int64
    where the JAX one holds int32 indices: torch's index dtype). The rest is
    derived from them once, when the geometry is built:
    - ``node_layer`` [H, W]: the layer of each valid node, 0 at padding (a
      gather index; what it reads at padding is never used);
    - ``node_segment`` [H, W]: the layer of each valid node, L at padding
      (the segment of the min-marginal scatter; slot L is dropped);
    - ``child`` [H, 2, W]: per arc (lo, hi) an index into a costs-to-terminal
      row extended by two slots, [cft_next..., 0, +inf]: the child's slot for
      an internal arc, W for a TOP arc, W + 1 for a BOT arc or padding;
    - ``dest`` [H, 2W]: per arc (lo arcs, then hi arcs) the slot of the next
      frontier row it relaxes, W (dropped) for terminal arcs and padding;
    - ``order`` / ``segments``: the valid layers (flat [H * L] indices)
      sorted by variable, stable, and their count per variable with an
      empty last segment for the sentinel V: the per-variable sums.
    """

    node_valid: torch.Tensor  # bool [H, W]
    layer_local: torch.Tensor  # int64 [H, W], pad -> L
    lo_kind: torch.Tensor  # int64 [H, W]
    lo_next: torch.Tensor  # int64 [H, W], pad/terminal -> W
    hi_kind: torch.Tensor
    hi_next: torch.Tensor
    layer_valid: torch.Tensor  # bool [H, L]
    layer_var: torch.Tensor  # int64 [H, L], pad -> V (sentinel delta slot)
    alpha: torch.Tensor  # [H, L] isotropic distribution weights (1/#bdds(var))
    num_bdds_per_var: torch.Tensor  # int64 [V]
    node_layer: torch.Tensor  # int64 [H, W]
    node_segment: torch.Tensor  # int64 [H, W]
    child: torch.Tensor  # int64 [H, 2, W]
    dest: torch.Tensor  # int64 [H, 2W]
    order: torch.Tensor  # int64 [Ev]
    segments: torch.Tensor  # int64 [V + 1]

    @property
    def H(self) -> int:
        return self.node_valid.shape[0]

    @property
    def W(self) -> int:
        return self.node_valid.shape[1]

    @property
    def L(self) -> int:
        return self.layer_valid.shape[1]

    @property
    def V(self) -> int:
        return self.num_bdds_per_var.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.alpha.dtype

    @property
    def device(self) -> torch.device:
        return self.alpha.device


class SolverState(NamedTuple):
    lo: torch.Tensor  # [H, L]
    hi: torch.Tensor  # [H, L]
    def_mm: torch.Tensor  # [H, L]
    cft: torch.Tensor  # [H, W] cost-from-terminal of the last backward sweep


def geom_from_arrays(node_valid, layer_local, lo_kind, lo_next, hi_kind, hi_next,
                     layer_valid, layer_var, alpha, num_bdds_per_var,
                     dtype=torch.float32, device="cuda") -> DenseGeom:
    """A geometry from its ten host arrays (numpy; alpha in float64, cast to
    ``dtype`` once), with the derived index arrays of :class:`DenseGeom`."""
    device = resolve_device(device)
    nv = np.asarray(node_valid, dtype=bool)
    H, W = nv.shape
    lvalid = np.asarray(layer_valid, dtype=bool)
    L = lvalid.shape[1]
    V = len(num_bdds_per_var)
    llocal = np.asarray(layer_local, dtype=np.int64)
    kinds = [np.asarray(lo_kind, dtype=np.int64), np.asarray(hi_kind, dtype=np.int64)]
    nexts = [np.asarray(lo_next, dtype=np.int64), np.asarray(hi_next, dtype=np.int64)]
    child = np.stack([
        np.where(~nv | (k == ARC_BOT), W + 1, np.where(k == ARC_TOP, W, n))
        for k, n in zip(kinds, nexts)], axis=1)
    dest = np.concatenate([np.where(nv & (k == ARC_INTERNAL), n, W)
                           for k, n in zip(kinds, nexts)], axis=1)
    lvar = np.asarray(layer_var, dtype=np.int64)
    ids = np.where(lvalid, lvar, V).ravel()
    real = np.nonzero(lvalid.ravel())[0]
    order = real[np.argsort(ids[real], kind="stable")]
    lengths = np.bincount(ids[real], minlength=V)[:V]
    check_lengths(lengths, order.size)

    def t(x, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device, dt) if dt is not None else x.to(device)

    return DenseGeom(
        node_valid=t(nv),
        layer_local=t(llocal),
        lo_kind=t(kinds[0]),
        lo_next=t(nexts[0]),
        hi_kind=t(kinds[1]),
        hi_next=t(nexts[1]),
        layer_valid=t(lvalid),
        layer_var=t(lvar),
        alpha=t(np.asarray(alpha, dtype=np.float64), dtype),
        num_bdds_per_var=t(np.asarray(num_bdds_per_var, dtype=np.int64)),
        node_layer=t(np.where(nv, llocal, 0)),
        node_segment=t(np.where(nv, llocal, L)),
        child=t(child),
        dest=t(dest),
        order=t(order.astype(np.int64)),
        segments=t(np.append(lengths, 0).astype(np.int64)),
    )


def geom_from_dense(dense: DenseBdds, dtype=torch.float32, device="cuda") -> DenseGeom:
    alpha = np.zeros((dense.H, dense.L), dtype=np.float64)
    lv = dense.layer_var
    valid = dense.layer_valid
    alpha[valid] = 1.0 / dense.num_bdds_per_var[lv[valid]]
    return geom_from_arrays(dense.node_valid, dense.layer_local, dense.lo_kind, dense.lo_next,
                            dense.hi_kind, dense.hi_next, dense.layer_valid, dense.layer_var,
                            alpha, dense.num_bdds_per_var, dtype, device)


def init_state(geom: DenseGeom, dense: DenseBdds, objective) -> SolverState:
    """Objective split evenly over each variable's BDDs (hi costs), zero lo
    costs and deferred marginals, clean backward run; in the geometry's
    dtype."""
    obj = np.asarray(objective, dtype=np.float64)
    lo = np.zeros((dense.H, dense.L), dtype=np.float64)
    hi = np.zeros((dense.H, dense.L), dtype=np.float64)
    valid = dense.layer_valid
    lv = dense.layer_var[valid]
    hi[valid] = obj[lv] / dense.num_bdds_per_var[lv]
    lo_t = torch.from_numpy(lo).to(geom.device, geom.dtype)
    hi_t = torch.from_numpy(hi).to(geom.device, geom.dtype)
    return SolverState(lo=lo_t, hi=hi_t, def_mm=torch.zeros_like(lo_t),
                       cft=backward_run(geom, lo_t, hi_t))


# ---------------------------------------------------------------- primitives
def _extended_rows(H: int, W: int, like: torch.Tensor) -> torch.Tensor:
    """[H + 1, W + 2] costs-to-terminal rows, +inf, each extended by the TOP
    slot (column W: 0) and the BOT slot (column W + 1: +inf): what
    ``DenseGeom.child`` indexes. Row H stands past the last hop."""
    out = torch.full((H + 1, W + 2), INF, dtype=like.dtype, device=like.device)
    out[:, W].fill_(0.0)
    return out


def _padded_rows(cft: torch.Tensor) -> torch.Tensor:
    """:func:`_extended_rows` holding cft [H, W] in rows 0..H-1."""
    H, W = cft.shape
    out = _extended_rows(H, W, cft)
    out[:H, :W] = cft
    return out


def _children(rows: torch.Tensor, child: torch.Tensor) -> torch.Tensor:
    """Costs-to-terminal of the children along both arcs, [2, W], from one
    extended row [W + 2] of :func:`_padded_rows`."""
    return rows.index_select(0, child.reshape(-1)).view(child.shape)


def _node_costs(costs: torch.Tensor, node_layer: torch.Tensor) -> torch.Tensor:
    """[2, W]: each node's (lo, hi) layer cost from a [2, L] row pair."""
    return costs.gather(1, node_layer.expand(2, -1))


def _min_marginals_row(paths: torch.Tensor, segment: torch.Tensor, L: int) -> torch.Tensor:
    """[2, L]: the min over each layer's nodes of the (lo, hi) path costs
    [2, W] (``jax.ops.segment_min`` into L + 1 segments, the last dropped)."""
    out = torch.full((2, L + 1), INF, dtype=paths.dtype, device=paths.device)
    out.scatter_reduce_(1, segment.expand(2, -1), paths, "amin", include_self=True)
    return out[:, :L]


def _relax_next(vals: torch.Tensor, dest: torch.Tensor, W: int) -> torch.Tensor:
    """The next frontier row [W]: the min of the arc values [2, W] over the
    internal arcs into each slot (``_scatter_min_next``); +inf where none
    arrives."""
    out = torch.full((W + 1,), INF, dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, dest, vals.reshape(-1), "amin", include_self=True)
    return out[:W]


# -------------------------------------------------------------------- sweeps
def forward_run(geom: DenseGeom, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Shortest-path costs from the root, rows stacked [H, W]."""
    W = geom.W
    costs = torch.stack([lo, hi])
    rows = []
    row = torch.where(geom.node_valid[0], 0.0, INF).to(lo.dtype)
    for h in range(geom.H):
        rows.append(row)
        vals = row + _node_costs(costs[:, h], geom.node_layer[h])
        row = _relax_next(vals, geom.dest[h], W)
    return torch.stack(rows)


def backward_run(geom: DenseGeom, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Shortest-path costs to TOP, rows stacked [H, W]."""
    H, W = geom.H, geom.W
    costs = torch.stack([lo, hi])
    rows = _extended_rows(H, W, lo)
    for h in range(H - 1, -1, -1):
        t = _children(rows[h + 1], geom.child[h])
        c = _node_costs(costs[:, h], geom.node_layer[h])
        rows[h, :W] = torch.where(geom.node_valid[h], (c + t).amin(0), INF)
    return rows[:H, :W]


def lower_bound_from_cft(geom: DenseGeom, cft: torch.Tensor) -> torch.Tensor:
    """Sum of per-BDD root costs (roots are exactly the valid hop-0 slots),
    accumulated in float64 and cast back to the costs' dtype."""
    return torch.where(geom.node_valid[0], cft[0], 0.0).to(torch.float64).sum().to(cft.dtype)


def lower_bound_per_root_slot(geom: DenseGeom, cft: torch.Tensor) -> torch.Tensor:
    return torch.where(geom.node_valid[0], cft[0], 0.0)


def min_marginals(geom: DenseGeom, lo: torch.Tensor, hi: torch.Tensor,
                  cft: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer min marginals (m0, m1), [H, L]; padding -> +inf. All hops at
    once, as the JAX package's ``vmap``: a gather and a scatter over [H, W].
    ``cft``: optional clean backward run of (lo, hi); state.cft always
    qualifies (every mutating op ends with a backward refresh)."""
    H, W, L = geom.H, geom.W, geom.L
    cfr = forward_run(geom, lo, hi)
    if cft is None:
        cft = backward_run(geom, lo, hi)
    rows = _padded_rows(cft)[1:]  # [H, W + 2]: hop h + 1, extended
    c_lo = lo.gather(1, geom.node_layer)
    c_hi = hi.gather(1, geom.node_layer)
    t_lo = rows.gather(1, geom.child[:, 0])
    t_hi = rows.gather(1, geom.child[:, 1])
    out = []
    for c, t in ((c_lo, t_lo), (c_hi, t_hi)):
        m = torch.full((H, L + 1), INF, dtype=lo.dtype, device=lo.device)
        m.scatter_reduce_(1, geom.node_segment, cfr + c + t, "amin", include_self=True)
        out.append(m[:, :L])
    return out[0], out[1]


# ----------------------------------------------------------------- iteration
def delta_sums(geom: DenseGeom, def_mm: torch.Tensor) -> torch.Tensor:
    """Per-variable sums [V + 1, 2] of (relu(-def_mm), relu(def_mm)) over the
    valid layers; row V (padding) is 0. One segment reduction over the fixed
    variable order: the two columns are reduced together, one sequential
    loop per variable and column."""
    m = def_mm.reshape(-1)[geom.order]
    contrib = uf.relu(torch.stack([-m, m], dim=1), inplace=True)
    return torch.segment_reduce(contrib, "sum", lengths=geom.segments, axis=0, unsafe=True,
                                initial=0.0)


def compute_delta(geom: DenseGeom, def_mm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-variable deferred deltas [V+1] (last entry = padding slot, 0).
    delta_lo = sum relu(-def_mm), delta_hi = sum relu(def_mm) per variable;
    infinite def_mm encodes variable forcing and propagates as +inf."""
    d = delta_sums(geom, def_mm)
    return d[:, 0], d[:, 1]


def forward_iteration(geom: DenseGeom, state: SolverState, omega: float,
                      delta=None) -> Tuple[SolverState, torch.Tensor]:
    """Forward half-sweep: returns (new state [cft unchanged], cfr [H, W]).
    ``omega``: the damping, a number.

    ``delta``: optional precomputed per-variable (delta_lo, delta_hi) [V+1]
    pair; the sharded solve passes the deltas summed across its ranks."""
    H, W, L = geom.H, geom.W, geom.L
    dlo, dhi = compute_delta(geom, state.def_mm) if delta is None else delta
    din_lo, din_hi = dlo[geom.layer_var], dhi[geom.layer_var]
    costs = torch.stack([state.lo, state.hi])
    rows = _padded_rows(state.cft)
    new_costs, new_mm, cfr = [], [], []
    row = torch.where(geom.node_valid[0], 0.0, INF).to(state.lo.dtype)
    for h in range(H):
        t = _children(rows[h + 1], geom.child[h])
        paths = row + _node_costs(costs[:, h], geom.node_layer[h]) + t
        m = _min_marginals_row(paths, geom.node_segment[h], L)
        nl, nh, mm = uf._hop_cost_update(costs[0, h], costs[1, h], m[0], m[1], omega,
                                         geom.alpha[h], din_lo[h], din_hi[h],
                                         geom.layer_valid[h])
        nc = torch.stack([nl, nh])
        new_costs.append(nc)
        new_mm.append(mm)
        cfr.append(row)
        row = _relax_next(row + _node_costs(nc, geom.node_layer[h]), geom.dest[h], W)
    new_costs = torch.stack(new_costs, dim=1)
    return (state._replace(lo=new_costs[0], hi=new_costs[1], def_mm=torch.stack(new_mm)),
            torch.stack(cfr))


def backward_iteration(geom: DenseGeom, state: SolverState, omega: float,
                       cfr: torch.Tensor, delta=None) -> SolverState:
    """Backward half-sweep: returns the new state with refreshed cft."""
    H, W, L = geom.H, geom.W, geom.L
    dlo, dhi = compute_delta(geom, state.def_mm) if delta is None else delta
    din_lo, din_hi = dlo[geom.layer_var], dhi[geom.layer_var]
    costs = torch.stack([state.lo, state.hi])
    new_costs = torch.empty_like(costs)
    new_mm = torch.empty_like(state.def_mm)
    rows = _extended_rows(H, W, costs)
    for h in range(H - 1, -1, -1):
        t = _children(rows[h + 1], geom.child[h])
        paths = cfr[h] + _node_costs(costs[:, h], geom.node_layer[h]) + t
        m = _min_marginals_row(paths, geom.node_segment[h], L)
        nl, nh, mm = uf._hop_cost_update(costs[0, h], costs[1, h], m[0], m[1], omega,
                                         geom.alpha[h], din_lo[h], din_hi[h],
                                         geom.layer_valid[h])
        nc = torch.stack([nl, nh])
        new_costs[:, h] = nc
        new_mm[h] = mm
        rows[h, :W] = torch.where(geom.node_valid[h],
                                  (_node_costs(nc, geom.node_layer[h]) + t).amin(0), INF)
    return SolverState(lo=new_costs[0], hi=new_costs[1], def_mm=new_mm, cft=rows[:H, :W])


def iteration(geom: DenseGeom, state: SolverState, omega=0.5) -> SolverState:
    """One full dual MMA iteration: forward half-sweep, backward half-sweep,
    each after its own delta consensus."""
    state, cfr = forward_iteration(geom, state, omega)
    return backward_iteration(geom, state, omega, cfr)


def iterations(geom: DenseGeom, state: SolverState, n: int, omega=0.5) -> SolverState:
    for _ in range(n):
        state = iteration(geom, state, omega)
    return state


def distribute_delta(geom: DenseGeom, state: SolverState) -> SolverState:
    """Fold deferred deltas into the costs -> valid dual point."""
    dlo, dhi = compute_delta(geom, state.def_mm)
    return update_costs(geom, state._replace(def_mm=torch.zeros_like(state.def_mm)), dlo, dhi)


def lower_bound_with_deferred(geom: DenseGeom, state: SolverState) -> torch.Tensor:
    return lower_bound_from_cft(geom, distribute_delta(geom, state).cft)


def lower_bound(geom: DenseGeom, state: SolverState) -> torch.Tensor:
    return lower_bound_from_cft(geom, backward_run(geom, state.lo, state.hi))


def update_costs(geom: DenseGeom, state: SolverState, lo_u: torch.Tensor,
                 hi_u: torch.Tensor) -> SolverState:
    """Add per-variable cost deltas [V + 1] (sentinel last) split by the
    isotropic weights, with a fresh backward run (``_dense_update_costs`` of
    bdd_tpu/solver/wrapper.py)."""
    lo = state.lo + geom.alpha * lo_u[geom.layer_var]
    hi = state.hi + geom.alpha * hi_u[geom.layer_var]
    return state._replace(lo=lo, hi=hi, cft=backward_run(geom, lo, hi))


# --------------------------------------------------- solutions & dual algebra
def bdds_solution(geom: DenseGeom, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Per-layer 0/1 argmin-path choice of every BDD, [H, L] int8 (0 at
    layers no path visits): every hop advances all BDDs' path pointers in
    parallel; ties take the hi arc; dead and padding slots park at index W."""
    H, W, L = geom.H, geom.W, geom.L
    dev = lo.device
    rows = _padded_rows(backward_run(geom, lo, hi))
    costs = torch.stack([lo, hi])
    # per hop and arc, indexed by an active slot in 0..W (W: parked): the
    # child row index of the arc, and its next slot (W unless internal)
    child = torch.cat([geom.child, torch.full((H, 2, 1), W + 1, dtype=torch.int64, device=dev)],
                      dim=2)
    nxt = torch.cat([geom.dest.view(H, 2, W),
                     torch.full((H, 2, 1), W, dtype=torch.int64, device=dev)], dim=2)
    seg = torch.cat([geom.node_segment, torch.full((H, 1), L, dtype=torch.int64, device=dev)],
                    dim=1)
    node_layer = torch.cat([geom.node_layer, torch.zeros((H, 1), dtype=torch.int64,
                                                         device=dev)], dim=1)
    active = torch.where(geom.node_valid[0], torch.arange(W, device=dev), W)
    sol = []
    for h in range(H):
        t = rows[h + 1].index_select(0, child[h].index_select(1, active).reshape(-1)).view(2, W)
        c = costs[:, h].gather(1, node_layer[h].index_select(0, active).expand(2, -1))
        v = c + t
        take_hi = v[1] <= v[0]
        row = torch.zeros(L + 1, dtype=torch.int8, device=dev)
        row.scatter_(0, seg[h].index_select(0, active), take_hi.to(torch.int8))
        sol.append(row[:L])
        nx = nxt[h].index_select(1, active)
        active = torch.where(take_hi, nx[1], nx[0])
    return torch.stack(sol)


def net_solver_costs(geom: DenseGeom, state: SolverState) -> torch.Tensor:
    """Per-layer net cost x = (hi - lo) including the deferred delta share.
    [H, L], 0 at invalid layers."""
    dlo, dhi = compute_delta(geom, state.def_mm)
    dl = dlo[geom.layer_var]
    dh = dhi[geom.layer_var]
    fl, fh = torch.isfinite(dl), torch.isfinite(dh)
    # both-ways forcing (infeasible variable) has dl = dh = +inf; inf - inf
    # would inject NaN into the L-BFGS history: the share counts as 0 (the
    # run loop stops on the inf lower bound)
    diff = torch.where(fl & fh, dh - dl, torch.where(fl, INF, torch.where(fh, -INF, 0.0)))
    net = state.hi - state.lo + geom.alpha * diff
    return torch.where(geom.layer_valid, net, 0.0)


def var_sums(geom: DenseGeom, x: torch.Tensor) -> torch.Tensor:
    """Per-variable sums [V + 1] of a per-layer tensor [H, L] over the valid
    layers (row V: 0), by the fixed segment order."""
    return torch.segment_reduce(x.reshape(-1)[geom.order].unsqueeze(1), "sum",
                                lengths=geom.segments, axis=0, unsafe=True, initial=0.0)[:, 0]


def make_dual_feasible(geom: DenseGeom, g: torch.Tensor) -> torch.Tensor:
    """Zero-sum projection per primal variable: g -= mean over the variable's
    layers."""
    g = torch.where(geom.layer_valid, g, 0.0)
    proj = g - geom.alpha * var_sums(geom, g)[geom.layer_var]
    return torch.where(geom.layer_valid, proj, 0.0)


def gradient_step(geom: DenseGeom, state: SolverState, g: torch.Tensor,
                  step_size) -> SolverState:
    """hi_cost += step * g, with a fresh backward run."""
    hi = state.hi + torch.where(geom.layer_valid, step_size * g, 0.0)
    return state._replace(hi=hi, cft=backward_run(geom, state.lo, hi))
