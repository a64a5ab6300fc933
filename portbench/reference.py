"""Plain reference of the dual solve the benchmark times.

It imports nothing of the program under test and takes nothing the program made:
from a :class:`portbench.model.Model` it orders the variables, builds one BDD
per row and runs min-marginal averaging (MMA), all in plain numpy and torch.

Semantics, written out so that they can be checked against the program:

- Variable order: ``"input"`` keeps the model's order; ``"bfs"`` is a
  breadth-first order over the rows' variable graph (rows of up to 64
  variables are cliques, longer rows chains in row order), starting from the
  unvisited variable of least degree (ties by index), neighbours in index order.
- Rows: the terms of a row in the new order, zeros dropped; rows of one
  variable that every assignment meets are dropped. A row's BDD is the reduced
  ordered BDD of its feasible set; a variable that no node tests leaves the
  row's support, and the rest are quasi-reduced (every arc goes one level
  down, or to the false terminal; skipped levels become nodes whose two arcs
  meet). A row that every assignment meets makes no BDD. A variable that no
  BDD holds and that has a cost gets a BDD of its own that accepts both values.
- State: per (BDD, variable) slot the costs lo and hi of the two values and a
  deferred min-marginal difference mm; per node the cost to the terminal.
  Start: hi = cost / (BDDs of the variable), lo = mm = 0.
- An iteration: the exchange, a forward half-sweep over every BDD's levels,
  the exchange, a backward half-sweep. The exchange sums, per variable,
  relu(-mm) and relu(mm) over its slots. A half-sweep takes, level by level,
  each slot's exact min-marginals m0 and m1 under the current costs and sets
  ``r = omega * (m1 - m0)`` (0 unless both are finite),
  ``lo <- lo - relu(-r) + alpha * din_lo`` and ``hi <- hi - relu(r) + alpha * din_hi``
  (alpha = 1 / BDDs of the variable; an infinite delta is added unscaled; a
  value whose min-marginal is infinite becomes infinite) and ``mm <- r``
  (or -inf / +inf where m0 / m1 alone is infinite).
- The lower bound is the sum over BDDs of the root's cost to the terminal.

The solve runs level by level over all BDDs at once in ``dtype``; the
benchmark's check runs it in float64, its control in a lower precision.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.model import Model

TOP = -1
BOT = -2
INF = float("inf")
CLIQUE_MAX = 64  # rows longer than this join their variables as a chain


class Infeasible(ValueError):
    pass


# ---------------------------------------------------------------- order
def bfs_order(nr_vars: int, rows) -> np.ndarray:
    """Old variable index at each new position (see the module's docstring)."""
    src, dst = [], []
    for r in rows:
        vs = r.vars
        if len(vs) > CLIQUE_MAX:
            pairs = list(zip(vs[:-1], vs[1:]))
        else:
            pairs = [(a, b) for i, a in enumerate(vs) for b in vs[i + 1:]]
        for a, b in pairs:
            if a != b:
                src += (a, b)
                dst += (b, a)
    keys = np.unique(np.asarray(src, dtype=np.int64) * nr_vars + np.asarray(dst, dtype=np.int64))
    starts = np.searchsorted(keys // max(nr_vars, 1), np.arange(nr_vars + 1))
    deg = np.diff(starts)
    nbrs = (keys % max(nr_vars, 1)).tolist()
    starts = starts.tolist()
    visited = bytearray(nr_vars)
    order: List[int] = []
    for s in np.argsort(deg, kind="stable").tolist():
        if visited[s]:
            continue
        visited[s] = 1
        head = len(order)
        order.append(s)
        while head < len(order):
            u = order[head]
            head += 1
            for v in nbrs[starts[u]:starts[u + 1]]:
                if not visited[v]:
                    visited[v] = 1
                    order.append(v)
    return np.array(order, dtype=np.int64)


def new_positions(model: Model, order: str) -> np.ndarray:
    """New position of each model variable under ``order``."""
    n = len(model.var_names)
    if order == "input":
        return np.arange(n, dtype=np.int64)
    if order != "bfs":
        raise ValueError(f"the reference knows the orders 'input' and 'bfs', not {order!r}")
    pos = np.empty(n, dtype=np.int64)
    pos[bfs_order(n, model.rows)] = np.arange(n)
    return pos


# ----------------------------------------------------------------- BDDs
@dataclass
class Bdd:
    """A quasi-reduced BDD: ``pos`` [nodes] the level of each node (0 is the
    root's, nodes sorted by level), ``lo`` / ``hi`` the child's node index or
    TOP / BOT, ``support`` [levels] the index into the row's terms of each level."""

    pos: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    support: np.ndarray


def _clamp(i: int, b: np.ndarray, equal: bool, max_suffix: np.ndarray, n: int):
    """Per budget b at level i: 0 a state, TOP or BOT."""
    kind = np.zeros(b.shape, dtype=np.int64)
    if equal:
        kind[(b < 0) | (b > max_suffix[i])] = BOT
        if i == n:
            kind[kind == 0] = TOP
    else:
        kind[b >= max_suffix[i]] = TOP
        kind[b < 0] = BOT
    return kind


def build_bdd(coeffs: Sequence[int], sense: str, rhs: int) -> Optional[Bdd]:
    """The quasi-reduced BDD of ``sum coeffs_i x_i (sense) rhs`` over x in
    term order; None where every assignment meets the row."""
    c = np.asarray(coeffs, dtype=np.int64).copy()
    if sense == ">=":
        c, rhs = -c, -rhs
    equal = sense == "="
    flip = c < 0
    rhs = int(rhs - c[flip].sum())
    c = np.abs(c)
    n = len(c)
    max_suffix = np.concatenate([np.cumsum(c[::-1])[::-1], [0]])
    root_kind = _clamp(0, np.array([rhs]), equal, max_suffix, n)[0]
    if root_kind == TOP:
        return None
    if root_kind == BOT:
        raise Infeasible("a row no assignment meets")
    levels = [np.array([rhs], dtype=np.int64)]
    for i in range(n):
        b = np.concatenate([levels[i], levels[i] - c[i]])
        b = b[_clamp(i + 1, b, equal, max_suffix, n) == 0]
        levels.append(np.unique(b))
    # bottom-up: a budget's node, or the node or terminal it reduces to
    ref = [None] * (n + 1)
    ref[n] = np.zeros(0, dtype=np.int64)
    lv, lo_all, hi_all = [], [], []
    count = 0
    for i in range(n - 1, -1, -1):
        kids = []
        for b in (levels[i], levels[i] - c[i]):
            kind = _clamp(i + 1, b, equal, max_suffix, n)
            at = np.searchsorted(levels[i + 1], b).clip(max=max(len(levels[i + 1]) - 1, 0))
            kids.append(np.where(kind == 0, ref[i + 1][at] if len(ref[i + 1]) else 0, kind))
        lo, hi = kids
        same = lo == hi
        span = count + 2  # every child is below count, or a terminal
        keys, inv = np.unique((lo[~same] + 2) * span + hi[~same] + 2, return_inverse=True)
        r = lo.copy()
        r[~same] = count + inv.reshape(-1)
        ref[i] = r
        lv.append(np.full(len(keys), i))
        lo_all.append(keys // span - 2)
        hi_all.append(keys % span - 2)
        count += len(keys)
    root = int(ref[0][0])
    if root == TOP:
        return None
    if root == BOT:
        raise Infeasible("a row no assignment meets")
    level = np.concatenate(lv)
    lo = np.concatenate(lo_all)
    hi = np.concatenate(hi_all)
    swap = flip[level]
    lo, hi = np.where(swap, hi, lo), np.where(swap, lo, hi)
    return _quasi_reduce(level, lo, hi, root)


def _quasi_reduce(level, lo, hi, root) -> Bdd:
    used = np.unique(level)
    d = len(used)
    pos = np.searchsorted(used, level)
    m = len(level)
    # arcs that skip levels lead through a chain of don't-care nodes that every
    # arc to the same target shares: (level q, target) for q above the target
    arc_from = np.concatenate([pos, pos])
    arc_to = np.concatenate([lo, hi])
    tpos = np.where(arc_to == TOP, d, pos[np.clip(arc_to, 0, None)])
    long = (arc_to != BOT) & (tpos - arc_from > 1)
    targets, first = np.unique(arc_to[long], return_inverse=True)
    if len(targets):
        pmin = np.full(len(targets), d, dtype=np.int64)
        np.minimum.at(pmin, first.reshape(-1), arc_from[long])
        tp = np.where(targets == TOP, d, pos[np.clip(targets, 0, None)])
        length = tp - pmin - 1
        base = m + np.concatenate([[0], np.cumsum(length)[:-1]])  # chain id at level pmin + 1
        cpos = np.concatenate([np.arange(a + 1, b) for a, b in zip(pmin, tp)])
        cnext = np.concatenate(
            [np.append(np.arange(s + 1, s + k), t) for s, k, t in zip(base, length, targets)])
        # a long arc enters its target's chain at the level below its node
        entry = base[first.reshape(-1)] + (arc_from[long] - pmin[first.reshape(-1)])
        arc_to = arc_to.copy()
        arc_to[long] = entry
    else:
        cpos = cnext = np.zeros(0, dtype=np.int64)
    lo2, hi2 = arc_to[:m], arc_to[m:]
    allpos = np.concatenate([pos, cpos])
    alllo = np.concatenate([lo2, cnext])
    allhi = np.concatenate([hi2, cnext])
    order = np.argsort(allpos, kind="stable")
    # the root first at level 0: it is the only node there
    newid = np.empty(len(order), dtype=np.int64)
    newid[order] = np.arange(len(order))

    def remap(x):
        return np.where(x >= 0, newid[np.clip(x, 0, None)], x)

    assert allpos[root] == 0 and (allpos == 0).sum() == 1
    return Bdd(pos=allpos[order], lo=remap(alllo[order]), hi=remap(allhi[order]), support=used)


# ------------------------------------------------------------- the layout
@dataclass
class Layout:
    """Every BDD of a model, laid out level by level for the solve.

    Slots (one per BDD and level) are sorted by (level, BDD), nodes by (level,
    BDD); ``slot_bdd`` / ``slot_var`` give each slot's BDD and model variable.
    A child index is a node, or ``N`` (the true terminal) or ``N + 1`` (false).
    """

    nr_vars: int
    nr_bdds: int
    slot_bdd: np.ndarray
    slot_var: np.ndarray
    node_slot: np.ndarray  # the slot of each node's level
    node_bdd: np.ndarray
    child: np.ndarray  # [N, 2] lo and hi children
    slot_start: np.ndarray  # [levels + 1]
    node_start: np.ndarray  # [levels + 1]
    roots: np.ndarray  # [nr_bdds] node index of each BDD's root
    costs: np.ndarray  # [nr_vars] float64

    @property
    def nr_nodes(self) -> int:
        return len(self.node_slot)

    @property
    def nr_slots(self) -> int:
        return len(self.slot_bdd)


def _normal_rows(model: Model, newpos: np.ndarray):
    """The rows after reordering, zeros dropped and rows that every assignment
    meets left out: (coeffs in term order, model variables, sense, rhs)."""
    out = []
    for r in model.rows:
        merged: Dict[int, int] = {}
        for c, v in zip(r.coeffs, r.vars):
            merged[int(newpos[v])] = merged.get(int(newpos[v]), 0) + c
        items = sorted((p, c) for p, c in merged.items() if c != 0)
        if not items:
            ok = {"<=": r.rhs >= 0, ">=": r.rhs <= 0, "=": r.rhs == 0}[r.sense]
            if not ok:
                raise Infeasible(f"empty row {r.name}")
            continue
        if len(items) == 1 and r.sense != "=":
            c = items[0][1]
            if r.sense == "<=":
                if min(c, 0) > r.rhs:
                    raise Infeasible(f"row {r.name}")
                if max(c, 0) <= r.rhs:
                    continue
            else:
                if max(c, 0) < r.rhs:
                    raise Infeasible(f"row {r.name}")
                if min(c, 0) >= r.rhs:
                    continue
        out.append((tuple(c for _, c in items), [p for p, _ in items], r.sense, r.rhs))
    return out


def build_layout(model: Model, order: str) -> Layout:
    newpos = new_positions(model, order)
    old_of_new = np.argsort(newpos)
    templates: Dict[tuple, Optional[Bdd]] = {}
    groups: Dict[tuple, List[Tuple[int, np.ndarray]]] = {}
    nb = 0
    covered = np.zeros(len(newpos), dtype=bool)
    for coeffs, terms, sense, rhs in _normal_rows(model, newpos):
        key = (coeffs, sense, rhs)
        if key not in templates:
            templates[key] = build_bdd(coeffs, sense, rhs)
        t = templates[key]
        if t is None:
            continue
        vs = old_of_new[np.asarray(terms)[t.support]]
        covered[vs] = True
        groups.setdefault(key, []).append((nb, vs))
        nb += 1
    costs = model.costs()
    free = np.nonzero(~covered & (costs != 0.0))[0]
    if len(free):
        key = ("free",)
        templates[key] = Bdd(pos=np.zeros(1, np.int64), lo=np.array([TOP]), hi=np.array([TOP]),
                             support=np.zeros(1, np.int64))
        groups[key] = [(nb + i, np.array([v])) for i, v in enumerate(free)]
        nb += len(free)

    pos_l, bdd_l, lo_l, hi_l, svar_l, sbdd_l, spos_l = [], [], [], [], [], [], []
    base = 0
    for key, members in groups.items():
        t = templates[key]
        g = len(members)
        k = len(t.pos)
        bdds = np.array([b for b, _ in members], dtype=np.int64)
        off = base + k * np.arange(g, dtype=np.int64)[:, None]
        pos_l.append(np.tile(t.pos, g))
        bdd_l.append(np.repeat(bdds, k))
        for src, dst in ((t.lo, lo_l), (t.hi, hi_l)):
            dst.append(np.where(src[None] >= 0, off + src[None], src[None]).reshape(-1))
        d = len(t.support)
        svar_l.append(np.stack([vs for _, vs in members]).reshape(-1))
        sbdd_l.append(np.repeat(bdds, d))
        spos_l.append(np.tile(np.arange(d), g))
        base += k * g
    pos = np.concatenate(pos_l)
    nbdd = np.concatenate(bdd_l)
    order_n = np.lexsort((np.arange(len(pos)), nbdd, pos))
    newid = np.empty_like(order_n)
    newid[order_n] = np.arange(len(order_n))
    n = len(pos)
    child = np.stack([np.concatenate(lo_l), np.concatenate(hi_l)], 1)[order_n]
    child = np.where(child >= 0, newid[np.clip(child, 0, None)],
                     np.where(child == TOP, n, n + 1))
    pos, nbdd = pos[order_n], nbdd[order_n]
    spos = np.concatenate(spos_l)
    sbdd = np.concatenate(sbdd_l)
    svar = np.concatenate(svar_l)
    order_s = np.lexsort((sbdd, spos))
    spos, sbdd, svar = spos[order_s], sbdd[order_s], svar[order_s]
    levels = int(spos.max()) + 1
    skey = spos * nb + sbdd
    node_slot = np.searchsorted(skey, pos * nb + nbdd)
    roots = np.nonzero(pos == 0)[0]
    assert len(roots) == nb and (nbdd[roots] == np.arange(nb)).all()
    return Layout(
        nr_vars=len(newpos), nr_bdds=nb, slot_bdd=sbdd, slot_var=svar, node_slot=node_slot,
        node_bdd=nbdd, child=child,
        slot_start=np.searchsorted(spos, np.arange(levels + 1)),
        node_start=np.searchsorted(pos, np.arange(levels + 1)),
        roots=roots, costs=costs,
    )


# -------------------------------------------------------------- the solve
@dataclass
class Result:
    lower_bound: float
    bdd_bounds: np.ndarray  # float64 [nr_bdds]: each root's cost to the terminal
    lo: np.ndarray  # float64 [slots], in the layout's slot order
    hi: np.ndarray
    mm: np.ndarray


class Solver:
    """MMA on a :class:`Layout` in ``dtype`` on ``device``.

    Every quantity lies in (-inf, +inf]: costs only fall by finite amounts and
    the exchanged sums are not negative, so ``x == inf`` is the test for an
    infinite value. A slot's min-marginals are the least of its nodes' path
    costs, taken over a padded [slots, most nodes a slot] gather of each level
    (no atomics), or by a scatter where the padding would be far larger than
    the level. On a CUDA device the iterations after the first replay a CUDA
    graph of one iteration: the same operations without the host's launches.
    """

    PAD_LIMIT = 8  # padded entries a level may hold per node before it scatters

    def __init__(self, layout: Layout, dtype=torch.float64, device="cpu", omega: float = 0.5):
        self.L = layout
        self.dtype = dtype
        self.device = torch.device(device)
        self.omega = omega
        dev = self.device

        def t(x):
            return torch.as_tensor(x, device=dev)

        count = np.bincount(layout.slot_var, minlength=layout.nr_vars)
        self.slot_var = t(layout.slot_var)
        self.alpha = t(1.0 / count[layout.slot_var]).to(dtype)[:, None]
        self.start_hi = t(layout.costs[layout.slot_var] / count[layout.slot_var]).to(dtype)
        self.roots = t(layout.roots)
        self.sign = torch.tensor([-1.0, 1.0], dtype=dtype, device=dev)
        n = layout.nr_nodes
        widest = int(np.diff(layout.node_start).max())
        self.buf = torch.full((widest + 1, 2), INF, dtype=dtype, device=dev)  # last row: padding
        self.levels = []
        for k in range(len(layout.slot_start) - 1):
            s0, s1 = int(layout.slot_start[k]), int(layout.slot_start[k + 1])
            n0, n1 = int(layout.node_start[k]), int(layout.node_start[k + 1])
            loc = layout.node_slot[n0:n1] - s0
            per = np.bincount(loc, minlength=s1 - s0)
            most = int(per.max())
            if (s1 - s0) * most <= self.PAD_LIMIT * (n1 - n0) + 1024:
                first = np.concatenate([[0], np.cumsum(per)[:-1]])
                pad = first[:, None] + np.arange(most)[None]
                pad = t(np.where(np.arange(most)[None] < per[:, None], pad, widest))
            else:
                pad = None
            child = layout.child[n0:n1]
            inner = np.nonzero(child.reshape(-1) < n)[0]
            self.levels.append(dict(
                s=(s0, s1), n=(n0, n1), loc=t(loc), pad=pad, child=t(child),
                inner=t(inner), inner_child=t(child.reshape(-1)[inner])))
        self.cft = torch.full((n + 2,), INF, dtype=dtype, device=dev)
        self.cfr = torch.full((n + 2,), INF, dtype=dtype, device=dev)
        self.cft[n] = 0.0  # the true terminal; n + 1 is the false one
        self.cost = torch.zeros((layout.nr_slots, 2), dtype=dtype, device=dev)
        self.mm = torch.zeros(layout.nr_slots, dtype=dtype, device=dev)

    def start(self) -> None:
        self.cost[:, 0] = 0.0
        self.cost[:, 1] = self.start_hi
        self.mm.zero_()
        for lv in reversed(self.levels):
            (s0, s1), (n0, n1) = lv["s"], lv["n"]
            val = self.cost[s0:s1].index_select(0, lv["loc"]) + self._gather(self.cft, lv)
            torch.amin(val, 1, out=self.cft[n0:n1])

    def _exchange(self) -> torch.Tensor:
        """[slots, 2]: the sums of relu(-mm) and relu(mm) over each slot's variable."""
        contrib = torch.relu(self.mm[:, None] * self.sign)
        sums = torch.zeros((self.L.nr_vars, 2), dtype=self.dtype, device=self.device)
        sums.index_add_(0, self.slot_var, contrib)
        return sums.index_select(0, self.slot_var)

    @staticmethod
    def _gather(frontier: torch.Tensor, lv) -> torch.Tensor:
        """[nodes, 2]: the frontier value of each node's two children."""
        child = lv["child"]
        return frontier.index_select(0, child.reshape(-1)).view(child.shape)

    def _marginals(self, lv, from_root, to_terminal) -> torch.Tensor:
        """[slots, 2] min-marginals of a level's slots."""
        (s0, s1), (n0, n1) = lv["s"], lv["n"]
        val = self.cost[s0:s1].index_select(0, lv["loc"])
        val.add_(from_root[:, None])
        if lv["pad"] is None:
            val.add_(to_terminal)
            m = torch.full((s1 - s0, 2), INF, dtype=self.dtype, device=self.device)
            return m.scatter_reduce_(0, lv["loc"][:, None].expand(-1, 2), val, "amin")
        torch.add(val, to_terminal, out=self.buf[:n1 - n0])
        pad = lv["pad"]
        return self.buf.index_select(0, pad.reshape(-1)).view(*pad.shape, 2).amin(1)

    def _update(self, lv, m, din) -> torch.Tensor:
        """The MMA update of a level's slots from their min-marginals m."""
        s0, s1 = lv["s"]
        inf_m = m == INF
        r = (m[:, 1] - m[:, 0]).mul_(self.omega).masked_fill_(inf_m.any(1), 0.0)
        cost = self.cost[s0:s1]
        cost.sub_((r[:, None] * self.sign).clamp_min_(0.0))
        cost.addcmul_(self.alpha[s0:s1], din[s0:s1]).masked_fill_(inf_m, INF)
        mm = self.mm[s0:s1]
        mm.copy_(r).masked_fill_(inf_m[:, 0], -INF).masked_fill_(inf_m[:, 1], INF)
        return cost

    def iteration(self) -> None:
        din = self._exchange()
        self.cfr.fill_(INF)
        self.cfr.index_fill_(0, self.roots, 0.0)
        for lv in self.levels:
            n0, n1 = lv["n"]
            from_root = self.cfr[n0:n1]
            cost = self._update(lv, self._marginals(lv, from_root, self._gather(self.cft, lv)), din)
            push = cost.index_select(0, lv["loc"]).add_(from_root[:, None])
            push = push.reshape(-1).index_select(0, lv["inner"])
            self.cfr.scatter_reduce_(0, lv["inner_child"], push, "amin")
        din = self._exchange()
        for lv in reversed(self.levels):
            n0, n1 = lv["n"]
            kids = self._gather(self.cft, lv)
            cost = self._update(lv, self._marginals(lv, self.cfr[n0:n1], kids), din)
            torch.amin(cost.index_select(0, lv["loc"]).add_(kids), 1, out=self.cft[n0:n1])

    def run(self, iterations: int) -> None:
        if iterations <= 0:
            return
        self.iteration()
        if self.device.type != "cuda":
            for _ in range(iterations - 1):
                self.iteration()
            return
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.iteration()
        for _ in range(iterations - 1):
            graph.replay()
        torch.cuda.synchronize()

    def result(self) -> Result:
        roots = self.cft[self.roots].to(torch.float64).cpu().numpy()
        cost = self.cost.to(torch.float64).cpu().numpy()
        return Result(lower_bound=float(roots.sum()), bdd_bounds=roots, lo=cost[:, 0],
                      hi=cost[:, 1], mm=self.mm.to(torch.float64).cpu().numpy())


def solve(layout: Layout, iterations: int, dtype=torch.float64, device="cpu") -> Result:
    s = Solver(layout, dtype=dtype, device=device)
    s.start()
    s.run(iterations)
    return s.result()
