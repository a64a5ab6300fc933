"""Flat multi-BDD collection.

The central host-side BDD representation: every BDD is a contiguous slice of three
parallel arrays (variable, lo child, hi child) in topological order, root first.
Terminals are the sentinels ``TOP``/``BOT`` (mirroring the reference's two-sentinel
scheme, include/bdd_solver/bdd_cuda_base.h:53-55). This replaces the reference's
``bdd_collection`` instruction vectors (include/bdd_collection/bdd_collection.h:122-288)
with a design tailored to feeding the hop-major TPU arrays.

A BDD here is ordered w.r.t. *its own* variable sequence (one variable per depth
level). For BDDs built from constraints this coincides with ascending global
variable index; chunks produced by :meth:`split_qbdd` interleave auxiliary
variables and are ordered by level only — the dual decomposition couples
variables across BDDs purely by primal index, so no global order is required.

Supported operations (reference parity in parens):
  - add_bdd / evaluate / variables / nr_solutions   (bdd_collection.h:150-220)
  - make_qbdd: quasi-reduced form — every support variable appears on every
    root-to-TOP path (bdd_collection.cpp:1670-1812). Arcs into BOT are *not*
    chained: BOT paths carry +inf cost, so no per-layer cost accounting is needed.
  - bdd_and: melding/conjunction by product construction (bdd_collection.h:495-600)
  - reduce: canonical ROBDD reduction (bdd_collection.cpp:1063-1200)
  - rebase: variable renumbering; negate; fixed_variables
  - split_qbdd: chunk a long QBDD into depth-bounded pieces coupled by one-hot
    auxiliary variables (bdd_collection.cpp:507-780)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

TOP = -1
BOT = -2


def is_terminal(idx: int) -> bool:
    return idx < 0


class BddCollection:
    """A set of BDDs over a shared variable universe, stored flat."""

    def __init__(self) -> None:
        self.var: List[int] = []
        self.lo: List[int] = []
        self.hi: List[int] = []
        self.delim: List[int] = [0]  # per-BDD offsets into the node arrays

    # ------------------------------------------------------------------ basics
    def nr_bdds(self) -> int:
        return len(self.delim) - 1

    def nr_bdd_nodes(self, bdd_nr: Optional[int] = None) -> int:
        if bdd_nr is None:
            return len(self.var)
        return self.delim[bdd_nr + 1] - self.delim[bdd_nr]

    def root(self, bdd_nr: int) -> int:
        return self.delim[bdd_nr]

    def node_range(self, bdd_nr: int) -> Tuple[int, int]:
        return self.delim[bdd_nr], self.delim[bdd_nr + 1]

    def add_bdd(self, nodes: Sequence[Tuple[int, int, int]]) -> int:
        """Append a BDD given as local (var, lo, hi) triples, root at index 0,
        children referenced by local index (> parent index) or TOP/BOT."""
        base = len(self.var)
        for i, (v, lo, hi) in enumerate(nodes):
            assert v >= 0
            for c in (lo, hi):
                assert is_terminal(c) or (i < c < len(nodes)), (
                    f"node {i}: child {c} not topological"
                )
            self.var.append(v)
            self.lo.append(lo + base if lo >= 0 else lo)
            self.hi.append(hi + base if hi >= 0 else hi)
        self.delim.append(len(self.var))
        return self.nr_bdds() - 1

    def append_collection(
        self, other: "BddCollection", var_offset: int = 0
    ) -> None:
        """Bulk-append another collection; ``var_offset`` shifts its
        variable indices (instance batching into a shared space)."""
        base = len(self.var)
        self.var.extend(v + var_offset for v in other.var)
        self.lo.extend(c + base if c >= 0 else c for c in other.lo)
        self.hi.extend(c + base if c >= 0 else c for c in other.hi)
        self.delim.extend(d + base for d in other.delim[1:])

    def local_nodes(self, bdd_nr: int) -> List[Tuple[int, int, int]]:
        """Return (var, lo, hi) triples with bdd-local child indices."""
        s, e = self.node_range(bdd_nr)
        out = []
        for i in range(s, e):
            lo, hi = self.lo[i], self.hi[i]
            out.append(
                (self.var[i], lo - s if lo >= 0 else lo, hi - s if hi >= 0 else hi)
            )
        return out

    def variables(self, bdd_nr: int) -> List[int]:
        """Support variables in ascending global index. This is the path order
        for BDDs ordered w.r.t. the global variable order (all constraint-built
        BDDs); chunks from :meth:`split_qbdd` need :meth:`level_variables`."""
        s, e = self.node_range(bdd_nr)
        return sorted(set(self.var[s:e]))

    def level_variables(self, bdd_nr: int) -> List[int]:
        """Support variables in *path order* (one variable per depth level).
        Requires quasi-reduced form (every path visits every level)."""
        levels = self.node_levels(bdd_nr)
        s, _ = self.node_range(bdd_nr)
        by_level: Dict[int, int] = {}
        for i, lvl in enumerate(levels):
            v = self.var[s + i]
            if lvl in by_level:
                assert by_level[lvl] == v, "nodes at equal depth with distinct vars"
            else:
                by_level[lvl] = v
        return [by_level[l] for l in range(len(by_level))]

    def node_levels(self, bdd_nr: int) -> List[int]:
        """Depth (hop distance from root) of every node, local order.

        For an ordered (Q)BDD this equals the index of the node's variable in
        the BDD's variable sequence."""
        s, e = self.node_range(bdd_nr)
        level = [0] * (e - s)
        for i in range(s, e):
            for c in (self.lo[i], self.hi[i]):
                if not is_terminal(c):
                    level[c - s] = max(level[c - s], level[i - s] + 1)
        return level

    def min_max_variables(self, bdd_nr: int) -> Tuple[int, int]:
        s, e = self.node_range(bdd_nr)
        vs = self.var[s:e]
        return min(vs), max(vs)

    def nr_variables(self) -> int:
        return max(self.var) + 1 if self.var else 0

    # -------------------------------------------------------------- evaluation
    def evaluate(self, bdd_nr: int, assignment: Sequence[int]) -> bool:
        n = self.root(bdd_nr)
        while not is_terminal(n):
            n = self.hi[n] if assignment[self.var[n]] else self.lo[n]
        return n == TOP

    def nr_solutions(
        self,
        bdd_nr: int,
        positive_variables: Sequence[int] = (),
        negative_variables: Sequence[int] = (),
    ) -> int:
        """Count accepting assignments over the BDD's support variables,
        optionally restricted to assignments forcing the given variables to
        1 / 0 (ref: bdd_collection.h:148 ``bdd_nr_solutions`` — declared but
        never defined there; implemented here). Requires an ordered BDD (each
        variable at one level; skips allowed)."""
        support = self.variables(bdd_nr)
        pos = {v: i for i, v in enumerate(support)}
        d = len(support)
        force: Dict[int, int] = {}
        for v in positive_variables:
            force[v] = 1
        for v in negative_variables:
            assert force.get(v, 0) == 0, f"variable {v} forced both ways"
            force[v] = 0
        # free_before[i] = #unforced support vars at positions < i
        free_before = [0] * (d + 1)
        for i, v in enumerate(support):
            free_before[i + 1] = free_before[i] + (0 if v in force else 1)

        def span(a: int, b: int) -> int:
            return 2 ** (free_before[b] - free_before[a])

        memo: Dict[int, int] = {}

        def count(n: int, depth: int) -> int:
            if n == TOP:
                return span(depth, d)
            if n == BOT:
                return 0
            v = self.var[n]
            npos = pos[v]
            scale = span(depth, npos)
            if n not in memo:
                if v in force:
                    child = self.hi[n] if force[v] else self.lo[n]
                    memo[n] = count(child, npos + 1)
                else:
                    memo[n] = count(self.lo[n], npos + 1) + count(
                        self.hi[n], npos + 1
                    )
            return scale * memo[n]

        return count(self.root(bdd_nr), 0)

    def solutions(self, bdd_nr: int) -> List[Dict[int, int]]:
        """Enumerate accepting assignments over the support (tests only)."""
        support = self.variables(bdd_nr)
        out = []
        width = max(support) + 1
        for bits in range(2 ** len(support)):
            full = [0] * width
            assignment = {}
            for i, v in enumerate(support):
                assignment[v] = (bits >> i) & 1
                full[v] = assignment[v]
            if self.evaluate(bdd_nr, full):
                out.append(assignment)
        return out

    def fixed_variables(self, bdd_nr: int) -> Tuple[List[int], List[int]]:
        """Variables forced to 0 / 1 in every accepting assignment
        (O(support x nodes) via the forcing solution counter — the previous
        solutions() enumeration was 2^|support|)."""
        support = self.variables(bdd_nr)
        zeros, ones = [], []
        for v in support:
            if self.nr_solutions(bdd_nr, positive_variables=[v]) == 0:
                zeros.append(v)
            if self.nr_solutions(bdd_nr, negative_variables=[v]) == 0:
                ones.append(v)
        return zeros, ones

    # -------------------------------------------------------------------- qbdd
    def is_qbdd(self, bdd_nr: int) -> bool:
        """True iff every root-to-TOP arc advances exactly one level and TOP is
        only reached from the last level."""
        levels = self.node_levels(bdd_nr)
        d = max(levels) + 1 if levels else 0
        s, e = self.node_range(bdd_nr)
        for i in range(s, e):
            li = levels[i - s]
            for c in (self.lo[i], self.hi[i]):
                if c == BOT:
                    continue
                if c == TOP:
                    if li != d - 1:
                        return False
                elif levels[c - s] != li + 1:
                    return False
        return True

    def make_qbdd(self, bdd_nr: int, out: Optional["BddCollection"] = None) -> int:
        """Append the quasi-reduced form of ``bdd_nr`` to ``out`` (default: self).

        Every arc skipping support variables — including arcs into TOP before the
        last support variable — is routed through shared don't-care chain nodes so
        that every root-to-TOP path tests every support variable exactly once.
        Arcs into BOT stay direct (+inf paths need no cost accounting).
        (ref semantics: bdd_collection.cpp:1670-1812)
        """
        if out is None:
            out = self
        support = self.variables(bdd_nr)
        pos = {v: i for i, v in enumerate(support)}
        d = len(support)
        local = self.local_nodes(bdd_nr)
        nodes: List[Tuple[int, int, int]] = [(v, lo, hi) for (v, lo, hi) in local]
        chain_memo: Dict[Tuple[int, int], int] = {}

        def target_pos(c_local: int) -> int:
            return d if c_local == TOP else pos[nodes[c_local][0]]

        def mkchain(p: int, c_local: int, tp: int) -> int:
            """Don't-care chain covering support positions p..tp-1, then c
            (iterative bottom-up: big-M constraints skip thousands of levels,
            which would blow Python's recursion limit)."""
            child = c_local
            for q in range(tp - 1, p - 1, -1):
                key = (q, c_local)
                hit = chain_memo.get(key)
                if hit is not None:
                    child = hit
                    continue
                nodes.append((support[q], child, child))
                child = chain_memo[key] = len(nodes) - 1
            return child

        def route(p_from: int, c_local: int) -> int:
            if c_local == BOT:
                return BOT
            return mkchain(p_from + 1, c_local, target_pos(c_local))

        for i, (v, lo, hi) in enumerate(local):
            p = pos[v]
            nodes[i] = (v, route(p, lo), route(p, hi))

        return out.add_bdd(_topo_sort(nodes, 0))

    # --------------------------------------------------------------- reduction
    def reduce(self, bdd_nr: int, out: Optional["BddCollection"] = None) -> int:
        """Append the canonically reduced ROBDD of ``bdd_nr``."""
        if out is None:
            out = self
        return out.add_bdd(_reduce_local(self.local_nodes(bdd_nr)))

    # ---------------------------------------------------------------- and / or
    def bdd_and(
        self, bdd_nrs: Sequence[int], out: Optional["BddCollection"] = None
    ) -> int:
        """Conjunction (melding) of several BDDs via product construction over
        the shared ascending-variable order. Returns the new BDD number.
        (ref: bdd_collection.h:495-600 multi-way meld)"""
        return self._product(bdd_nrs, out, absorb=BOT, ident=TOP)

    def bdd_or(
        self, bdd_nrs: Sequence[int], out: Optional["BddCollection"] = None
    ) -> int:
        """Disjunction of several BDDs (ref: bdd_collection.h:138 ``bdd_or`` —
        declared there but never defined; implemented here as the dual meld)."""
        return self._product(bdd_nrs, out, absorb=TOP, ident=BOT)

    def _product(
        self,
        bdd_nrs: Sequence[int],
        out: Optional["BddCollection"],
        absorb: int,
        ident: int,
    ) -> int:
        """Multi-way product construction; ``absorb`` is the terminal that
        short-circuits the result (BOT for and, TOP for or), ``ident`` the
        neutral terminal."""
        if out is None:
            out = self
        assert len(bdd_nrs) >= 1
        if len(bdd_nrs) == 1:
            return self.reduce(bdd_nrs[0], out)

        memo: Dict[Tuple[int, ...], int] = {}
        cons: Dict[Tuple[int, int, int], int] = {}
        new_nodes: List[Tuple[int, int, int]] = []

        # iterative product construction (avoids recursion limits)
        def prod(state0: Tuple[int, ...]) -> int:
            stack = [state0]
            while stack:
                state = stack[-1]
                key = tuple(sorted(state))
                if key in memo:
                    stack.pop()
                    continue
                if any(n == absorb for n in state):
                    memo[key] = absorb
                    stack.pop()
                    continue
                live = [n for n in state if n != ident]
                if not live:
                    memo[key] = ident
                    stack.pop()
                    continue
                v = min(self.var[n] for n in live)
                lo_state = tuple(
                    self.lo[n] if (not is_terminal(n) and self.var[n] == v) else n
                    for n in state
                )
                hi_state = tuple(
                    self.hi[n] if (not is_terminal(n) and self.var[n] == v) else n
                    for n in state
                )
                lo_key = tuple(sorted(lo_state))
                hi_key = tuple(sorted(hi_state))
                # pre-resolve trivial children
                ready = True
                for s, k in ((lo_state, lo_key), (hi_state, hi_key)):
                    if k in memo:
                        continue
                    if any(n == absorb for n in s):
                        memo[k] = absorb
                    elif all(n == ident for n in s):
                        memo[k] = ident
                    else:
                        stack.append(s)
                        ready = False
                if not ready:
                    continue
                lo_r, hi_r = memo[lo_key], memo[hi_key]
                if lo_r == hi_r:
                    memo[key] = lo_r
                else:
                    ckey = (v, lo_r, hi_r)
                    if ckey not in cons:
                        new_nodes.append(ckey)
                        cons[ckey] = len(new_nodes) - 1
                    memo[key] = cons[ckey]
                stack.pop()
            return memo[tuple(sorted(state0))]

        root = prod(tuple(self.root(b) for b in bdd_nrs))
        if root == BOT:
            raise ValueError("bdd product: result is unsatisfiable")
        if root == TOP:
            raise ValueError("bdd product: result is trivially true")
        return out.add_bdd(_topo_sort(new_nodes, root))

    # ------------------------------------------------------------------ rebase
    def rebase(self, bdd_nr: int, var_map: Dict[int, int]) -> None:
        """Renumber variables of one BDD in place."""
        s, e = self.node_range(bdd_nr)
        for i in range(s, e):
            self.var[i] = var_map[self.var[i]]

    def negate(self, bdd_nr: int, out: Optional["BddCollection"] = None) -> int:
        if out is None:
            out = self
        local = self.local_nodes(bdd_nr)
        flipped = [
            (
                v,
                (TOP if lo == BOT else BOT if lo == TOP else lo),
                (TOP if hi == BOT else BOT if hi == TOP else hi),
            )
            for (v, lo, hi) in local
        ]
        return out.add_bdd(flipped)

    def bdd_or_var(
        self,
        bdd_nr: int,
        positive_variables: Sequence[int],
        negative_variables: Sequence[int] = (),
        out: Optional["BddCollection"] = None,
    ) -> int:
        """Append the relaxation f ∨ (⋁_{v∈pos} x_v) ∨ (⋁_{v∈neg} ¬x_v).
        Used by cut tightening to weaken a constraint on selected variables
        (ref: bdd_collection.h:603-646). The reference reroutes hi arcs to the
        topsink, which is exact only when every accepting-or-rejecting path
        tests the relaxed variables (its test relaxes a prefix of a simplex),
        and its negative case is flagged 'possible bug here' and disabled.
        Here: exact disjunction with a literal-clause BDD via the product
        construction, both polarities supported."""
        if out is None:
            out = self
        pos, neg = set(positive_variables), set(negative_variables)
        assert not (pos & neg), "a variable cannot be both positive and negative"
        if not pos and not neg:
            return self.reduce(bdd_nr, out)
        scratch = BddCollection()
        f = scratch.add_bdd(self.local_nodes(bdd_nr))
        lits = sorted(pos | neg)
        nodes: List[Tuple[int, int, int]] = []
        for i, v in enumerate(lits):
            rest = i + 1 if i + 1 < len(lits) else BOT
            nodes.append((v, rest, TOP) if v in pos else (v, TOP, rest))
        clause = scratch.add_bdd(nodes)
        try:
            return scratch.bdd_or([f, clause], out)
        except ValueError:
            # the relaxation became a tautology (e.g. at-most-one(x, y)
            # ∨ x ∨ y): represent 'true' as a single don't-care node so
            # tightening can keep (or drop) the constraint instead of
            # crashing
            return out.add_bdd([(lits[0], TOP, TOP)])

    def invert(self, bdd_nr: int, variables) -> None:
        """Substitute x_v ← ¬x_v for the given variables by swapping lo/hi
        children in place (ref: bdd_collection.cpp:2029-2037)."""
        vs = {variables} if isinstance(variables, int) else set(variables)
        s, e = self.node_range(bdd_nr)
        for i in range(s, e):
            if self.var[i] in vs:
                self.lo[i], self.hi[i] = self.hi[i], self.lo[i]

    def remove(self, bdd_nrs) -> None:
        """Delete the given BDDs and renumber the survivors (ref:
        bdd_collection.cpp:1387-1427). Child indices are intra-BDD, so the
        surviving slices just shift."""
        drop = {bdd_nrs} if isinstance(bdd_nrs, int) else set(bdd_nrs)
        nv: List[int] = []
        nl: List[int] = []
        nh: List[int] = []
        nd: List[int] = [0]
        for b in range(self.nr_bdds()):
            if b in drop:
                continue
            s, e = self.node_range(b)
            shift = len(nv) - s
            nv.extend(self.var[s:e])
            nl.extend(c + shift if c >= 0 else c for c in self.lo[s:e])
            nh.extend(c + shift if c >= 0 else c for c in self.hi[s:e])
            nd.append(len(nv))
        self.var, self.lo, self.hi, self.delim = nv, nl, nh, nd

    # --------------------------------------------------- constraint constructors
    # Direct builders mirroring bdd_collection.h:247-250 (impls at
    # bdd_collection.cpp:2039-2200); here via the managed builders + import.
    def simplex_constraint(self, n: int) -> int:
        """Exactly-one over variables 0..n-1."""
        from .manager import BddMgr

        m = BddMgr()
        return m.add_to_collection(m.simplex(list(range(n))), self)

    def not_all_false_constraint(self, n: int) -> int:
        """At-least-one over variables 0..n-1 (ref: bdd_collection.cpp:2105)."""
        from .manager import BddMgr

        m = BddMgr()
        return m.add_to_collection(m.at_least(list(range(n)), 1), self)

    def all_equal_constraint(self, n: int) -> int:
        from .manager import BddMgr

        m = BddMgr()
        return m.add_to_collection(m.all_equal(list(range(n))), self)

    def cardinality_constraint(self, n: int, k: int) -> int:
        """Exactly-k over variables 0..n-1."""
        from .manager import BddMgr

        m = BddMgr()
        return m.add_to_collection(m.cardinality(list(range(n)), k, k), self)

    # ------------------------------------------------------------- split_qbdd
    def split_qbdd(
        self,
        bdd_nr: int,
        chunk_size: int,
        aux_var_start: int,
        out: Optional["BddCollection"] = None,
        with_implication_bdd: bool = False,
    ) -> Tuple[List[int], int]:
        """Split a long QBDD into depth-<=~chunk_size chunks coupled by one-hot
        auxiliary variables (ref semantics: bdd_collection.cpp:507-780).

        At each cut the frontier nodes {n_0..n_{w-1}} opening the next chunk are
        encoded by w fresh one-hot auxiliary variables: the head chunk appends a
        one-hot tail forcing exactly the reached frontier node's aux variable to
        1; the tail chunk starts with a dispatch block on the same variables.
        Feasible joint assignments of both chunks therefore correspond exactly
        to paths of the original BDD. Returns (new bdd numbers, next free aux
        variable index).

        ``with_implication_bdd`` (ref: bdd_collection.cpp:806-935) additionally
        appends ONE redundant BDD over the auxiliary variables that encodes the
        reachability structure between cut frontiers (exactly-one per cut plus,
        for every pair of cuts and every frontier node, "this node's aux var
        implies some aux var of a frontier node connected to it by a directed
        path" — both directions). It is implied by the chunk conjunction but
        propagates dual information across chunks faster. Omitted when every
        such implication is trivial (all nodes mutually reachable) or when
        there are fewer than two cuts.
        """
        if out is None:
            out = self
        assert self.is_qbdd(bdd_nr), "split_qbdd requires quasi-reduced input"
        levels = self.node_levels(bdd_nr)
        d = max(levels) + 1
        if d <= chunk_size:
            return [self.make_qbdd(bdd_nr, out)], aux_var_start

        local = self.local_nodes(bdd_nr)
        by_pos: List[List[int]] = [[] for _ in range(d)]
        for i, lvl in enumerate(levels):
            by_pos[lvl].append(i)

        new_bdds: List[int] = []
        next_aux = aux_var_start
        cut_starts = list(range(0, d, chunk_size))
        # per cut: (boundary level, frontier node list, node -> aux var)
        cuts: List[Tuple[int, List[int], Dict[int, int]]] = []
        entry_aux: Optional[Dict[int, int]] = None  # frontier node -> aux var
        for ci, p0 in enumerate(cut_starts):
            p1 = min(p0 + chunk_size, d)
            frontier_next = by_pos[p1] if p1 < d else []
            exit_aux: Optional[Dict[int, int]] = None
            if frontier_next:
                exit_aux = {n: next_aux + k for k, n in enumerate(frontier_next)}
                next_aux += len(frontier_next)
                cuts.append((p1, frontier_next, exit_aux))

            nodes: List[Tuple[int, int, int]] = []

            def add(v: int, lo: int, hi: int) -> int:
                nodes.append((v, lo, hi))
                return len(nodes) - 1

            node_map: Dict[int, int] = {}

            # 1) exit blocks: one-hot tail per frontier node
            if exit_aux is not None:
                aux_vars = sorted(exit_aux.values())
                for n in frontier_next:
                    a_n = exit_aux[n]
                    cur: int = TOP
                    for a in reversed(aux_vars):
                        if a == a_n:
                            cur = add(a, BOT, cur)
                        else:
                            cur = add(a, cur, BOT)
                    node_map[n] = cur

            # 2) chunk nodes bottom-up
            for p in range(p1 - 1, p0 - 1, -1):
                for n in by_pos[p]:
                    v, lo, hi = local[n]
                    lo_m = lo if is_terminal(lo) else node_map[lo]
                    hi_m = hi if is_terminal(hi) else node_map[hi]
                    node_map[n] = add(v, lo_m, hi_m)

            # 3) entry dispatch block (chunks after the first)
            if entry_aux is None:
                root_id = node_map[0]
            else:
                ent_vars = sorted(entry_aux.values())
                aux_of = {a: n for n, a in entry_aux.items()}

                def zeros_then(rest: List[int], target: int) -> int:
                    cur = target
                    for a in reversed(rest):
                        cur = add(a, cur, BOT)
                    return cur

                cur = BOT
                for k in range(len(ent_vars) - 1, -1, -1):
                    a = ent_vars[k]
                    hi_t = zeros_then(ent_vars[k + 1 :], node_map[aux_of[a]])
                    cur = add(a, cur, hi_t)
                root_id = cur
            new_bdds.append(out.add_bdd(_topo_sort(nodes, root_id)))
            entry_aux = exit_aux
        if with_implication_bdd and len(cuts) >= 2:
            impl = self._implication_bdd(local, by_pos, d, cuts, out)
            if impl is not None:
                new_bdds.append(impl)
        return new_bdds, next_aux

    def _implication_bdd(
        self,
        local: List[Tuple[int, int, int]],
        by_pos: List[List[int]],
        d: int,
        cuts: List[Tuple[int, List[int], Dict[int, int]]],
        out: "BddCollection",
    ) -> Optional[int]:
        """Build the redundant cross-chunk implication BDD for split_qbdd
        (ref: bdd_collection.cpp:806-935). The reference materialises the full
        transitive closure of the BDD DAG; here one forward bitmask sweep per
        cut yields the frontier-to-frontier reachability matrices, which give
        both the forward clauses (rows) and the reverse clauses (columns).
        Returns the appended BDD number, or None when every clause is trivial.
        """
        from bdd_tpu_torch.bdd.manager import BddMgr

        mgr = BddMgr()
        clauses: List[int] = []
        for _, frontier, aux in cuts:
            clauses.append(mgr.simplex(sorted(aux.values())))
        nontrivial = 0
        for i, (p_i, f_i, aux_i) in enumerate(cuts):
            # reach[n] = bitmask over positions of f_i that reach node n
            reach: Dict[int, int] = {n: 1 << k for k, n in enumerate(f_i)}
            w_i = len(f_i)
            full_i = (1 << w_i) - 1
            for p in range(p_i, d - 1):
                for n in by_pos[p]:
                    m = reach.get(n)
                    if not m:
                        continue
                    _, lo, hi = local[n]
                    if not is_terminal(lo):
                        reach[lo] = reach.get(lo, 0) | m
                    if not is_terminal(hi):
                        reach[hi] = reach.get(hi, 0) | m
            for p_j, f_j, aux_j in cuts[i + 1 :]:
                masks = [reach.get(n2, 0) for n2 in f_j]
                # forward: aux(n1) -> OR of aux(n2) reachable from n1
                for k, n1 in enumerate(f_i):
                    r = [n2 for n2, m in zip(f_j, masks) if (m >> k) & 1]
                    if len(r) == len(f_j):
                        continue
                    nontrivial += 1
                    cl = mgr.neg_projection(aux_i[n1])
                    for n2 in r:
                        cl = mgr.or_(cl, mgr.projection(aux_j[n2]))
                    clauses.append(cl)
                # reverse: aux(n2) -> OR of aux(n1) that reach n2
                for n2, m in zip(f_j, masks):
                    if m == full_i:
                        continue
                    nontrivial += 1
                    cl = mgr.neg_projection(aux_j[n2])
                    for k, n1 in enumerate(f_i):
                        if (m >> k) & 1:
                            cl = mgr.or_(cl, mgr.projection(aux_i[n1]))
                    clauses.append(cl)
        if nontrivial == 0:
            return None
        f = mgr.multi_and(clauses)
        # build + qbdd-normalise in a scratch collection so no intermediate
        # BDD leaks into `out` (the solver flattens every BDD it holds)
        scratch = BddCollection()
        nr = mgr.add_to_collection(f, scratch)
        if not scratch.is_qbdd(nr):
            nr = scratch.make_qbdd(nr)
        return out.add_bdd(scratch.local_nodes(nr))

    def export_graphviz(self, bdd_nr: int) -> str:
        """DOT export (ref: bdd_collection graphviz export)."""
        s, e = self.node_range(bdd_nr)
        lines = ["digraph bdd {"]
        for i in range(s, e):
            lines.append(f'  n{i} [label="x{self.var[i]}"];')
        lines.append('  top [label="1", shape=box];')
        lines.append('  bot [label="0", shape=box];')
        for i in range(s, e):
            for c, style in ((self.lo[i], "dashed"), (self.hi[i], "solid")):
                t = "top" if c == TOP else "bot" if c == BOT else f"n{c}"
                lines.append(f"  n{i} -> {t} [style={style}];")
        lines.append("}")
        return "\n".join(lines)

    def write_bdd_lp(self, costs) -> str:
        """Arc-flow LP export of the whole collection: one unit of flow per
        BDD from root to TOP; flow conservation per node; arcs carry the layer
        costs; coupling constraints equate per-variable hi-arc flow across
        BDDs (ref: bdd_collection.h write_bdd_lp arc-flow export).

        ``costs`` is either a mapping (bdd_nr, var) -> (lo_cost, hi_cost) per
        layer, or a per-variable objective sequence (the reference's
        ``write_bdd_lp(stream, cost_begin, cost_end)`` form) — each variable's
        cost is then placed on its first containing BDD (equivalent under the
        coupling constraints)."""
        if not hasattr(costs, "get"):
            per_var = list(costs)
            mapping = {}
            seen = set()
            for b in range(self.nr_bdds()):
                s, e = self.node_range(b)
                for i in range(s, e):
                    v = self.var[i]
                    if v not in seen and v < len(per_var):
                        seen.add(v)
                        mapping[(b, v)] = (0.0, float(per_var[v]))
            costs = mapping
        lines_obj, lines_cons = [], []
        var_terms: Dict[Tuple[int, int], List[str]] = {}
        for b in range(self.nr_bdds()):
            s, e = self.node_range(b)
            incoming = {i: [] for i in range(s, e)}
            outgoing = {i: [] for i in range(s, e)}
            for i in range(s, e):
                for c, kind in ((self.lo[i], "lo"), (self.hi[i], "hi")):
                    if c == BOT:
                        continue  # no flow may enter the rejecting sink
                    arc = f"f_{b}_{i}_{kind}"
                    outgoing[i].append(arc)
                    if c != TOP:
                        incoming[c].append(arc)
                    cost = costs.get((b, self.var[i]), (0.0, 0.0))
                    w = cost[1] if kind == "hi" else cost[0]
                    if w:
                        lines_obj.append(f"{w:+.12g} {arc}")
                    if kind == "hi":
                        var_terms.setdefault((b, self.var[i]), []).append(arc)
            root = self.root(b)
            lines_cons.append(" + ".join(outgoing[root]) + " = 1")
            for i in range(s, e):
                if i == root:
                    continue
                inc = " + ".join(incoming[i])
                outs = " - ".join(outgoing[i])
                if inc and outs:
                    lines_cons.append(f"{inc} - {outs} = 0")
                elif inc:  # all arcs lead to BOT: node unreachable by flow
                    lines_cons.append(f"{inc} = 0")
        # per-variable coupling: every BDD containing v must route the same
        # amount of hi flow (the Lagrange-coupled copies agree)
        by_var: Dict[int, List[Tuple[int, List[str]]]] = {}
        for (b, v), arcs in var_terms.items():
            by_var.setdefault(v, []).append((b, arcs))
        for v, groups in sorted(by_var.items()):
            groups.sort()
            first = " + ".join(groups[0][1])
            for b, arcs in groups[1:]:
                lines_cons.append(f"{first} - " + " - ".join(arcs) + " = 0")
        out = ["Minimize", " ".join(lines_obj) or "0", "Subject To"]
        out.extend(lines_cons)
        out.append("End")
        return "\n".join(out) + "\n"

    def __repr__(self) -> str:
        return f"BddCollection(nr_bdds={self.nr_bdds()}, nr_nodes={len(self.var)})"


def _reduce_local(
    local: Sequence[Tuple[int, int, int]]
) -> List[Tuple[int, int, int]]:
    """Canonical ROBDD reduction of local (var, lo, hi) triples (children after
    parents, root at 0). Returns topo-sorted triples of the reduced BDD."""
    n = len(local)
    red: Dict[int, int] = {}
    cons: Dict[Tuple[int, int, int], int] = {}
    new_nodes: List[Tuple[int, int, int]] = []

    def resolve(c: int) -> int:
        return c if is_terminal(c) else red[c]

    for i in range(n - 1, -1, -1):
        v, lo, hi = local[i]
        lo_r, hi_r = resolve(lo), resolve(hi)
        if lo_r == hi_r:
            red[i] = lo_r
            continue
        key = (v, lo_r, hi_r)
        if key not in cons:
            new_nodes.append(key)
            cons[key] = len(new_nodes) - 1
        red[i] = cons[key]
    root = red[0]
    if is_terminal(root):
        raise ValueError("BDD reduced to a terminal")
    return _topo_sort(new_nodes, root)


def _topo_sort(
    nodes: Sequence[Tuple[int, int, int]], root: int
) -> List[Tuple[int, int, int]]:
    """Order nodes reachable from ``root`` by depth (root first, children after
    parents). Children referenced by index into ``nodes`` or sentinels."""
    assert not is_terminal(root)
    # iterative DFS postorder of the reachable sub-DAG (child indices carry
    # no order guarantee here), then one longest-path relaxation pass over
    # the reversed postorder (a parents-first topological order): O(V + E)
    seen: Dict[int, bool] = {}
    post: List[int] = []
    stack: List[Tuple[int, bool]] = [(root, False)]
    while stack:
        n, done = stack.pop()
        if done:
            post.append(n)
            continue
        if n in seen:
            continue
        seen[n] = True
        stack.append((n, True))
        for c in (nodes[n][1], nodes[n][2]):
            if not is_terminal(c) and c not in seen:
                stack.append((c, False))
    depth: Dict[int, int] = {n: 0 for n in post}
    for n in reversed(post):
        for c in (nodes[n][1], nodes[n][2]):
            if not is_terminal(c):
                depth[c] = max(depth[c], depth[n] + 1)
    order = sorted(post, key=lambda n: (depth[n], n))
    new_id = {n: i for i, n in enumerate(order)}
    out = []
    for n in order:
        v, lo, hi = nodes[n]
        out.append(
            (
                v,
                lo if is_terminal(lo) else new_id[lo],
                hi if is_terminal(hi) else new_id[hi],
            )
        )
    return out
