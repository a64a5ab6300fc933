"""Classic hash-consed BDD manager.

L1 parity with the reference's pointer-based library (include/bdd_manager/
bdd_mgr.h:18-102): reduced ordered BDDs with a unique table, memoized apply
operations (and/or/xor/ite), negation, rebase, and direct constraint builders
(simplex / at_most / at_least / cardinality / all_equal,
bdd_mgr.h:252-426). Nodes are integer ids into flat arrays (no pointers, no
manual reference counting — Python owns lifetime; the reference's GC/unique-
table page machinery is an artifact of C++ memory management, not semantics).

Used by the preprocessor for melds the flat collection cannot express and as
the general-purpose boolean-function layer.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from bdd_tpu_torch.bdd.collection import BOT, TOP, BddCollection

TRUE = TOP  # -1
FALSE = BOT  # -2


def is_terminal(f: int) -> bool:
    return f < 0


class _NodeBudgetExceeded(Exception):
    pass


class BddMgr:
    def __init__(self) -> None:
        self.var: List[int] = []
        self.lo: List[int] = []
        self.hi: List[int] = []
        self._unique: Dict[Tuple[int, int, int], int] = {}
        self._cache: Dict[Tuple, int] = {}
        self._node_budget = None  # and_limited's mid-construction abort

    # ------------------------------------------------------------------ nodes
    def nr_nodes(self) -> int:
        return len(self.var)

    def _mk(self, v: int, lo: int, hi: int) -> int:
        if lo == hi:
            return lo
        key = (v, lo, hi)
        n = self._unique.get(key)
        if n is None:
            if (self._node_budget is not None
                    and len(self.var) >= self._node_budget):
                raise _NodeBudgetExceeded
            n = len(self.var)
            self.var.append(v)
            self.lo.append(lo)
            self.hi.append(hi)
            self._unique[key] = n
        return n

    def projection(self, v: int) -> int:
        """The function x_v."""
        return self._mk(v, FALSE, TRUE)

    def neg_projection(self, v: int) -> int:
        return self._mk(v, TRUE, FALSE)

    def topvar(self, f: int) -> int:
        assert not is_terminal(f)
        return self.var[f]

    # ------------------------------------------------------------- apply ops
    def negate(self, f: int) -> int:
        if f == TRUE:
            return FALSE
        if f == FALSE:
            return TRUE
        key = ("not", f)
        r = self._cache.get(key)
        if r is None:
            r = self._mk(self.var[f], self.negate(self.lo[f]), self.negate(self.hi[f]))
            self._cache[key] = r
        return r

    def _apply(self, op: str, f: int, g: int) -> int:
        # terminal rules
        if op == "and":
            if f == FALSE or g == FALSE:
                return FALSE
            if f == TRUE:
                return g
            if g == TRUE:
                return f
            if f == g:
                return f
        elif op == "or":
            if f == TRUE or g == TRUE:
                return TRUE
            if f == FALSE:
                return g
            if g == FALSE:
                return f
            if f == g:
                return f
        elif op == "xor":
            if f == g:
                return FALSE
            if f == FALSE:
                return g
            if g == FALSE:
                return f
            if f == TRUE:
                return self.negate(g)
            if g == TRUE:
                return self.negate(f)
        key = (op, min(f, g), max(f, g))
        r = self._cache.get(key)
        if r is not None:
            return r
        vf = self.var[f] if not is_terminal(f) else None
        vg = self.var[g] if not is_terminal(g) else None
        v = min(x for x in (vf, vg) if x is not None)
        f0, f1 = (self.lo[f], self.hi[f]) if vf == v else (f, f)
        g0, g1 = (self.lo[g], self.hi[g]) if vg == v else (g, g)
        r = self._mk(v, self._apply(op, f0, g0), self._apply(op, f1, g1))
        self._cache[key] = r
        return r

    def and_(self, f: int, g: int) -> int:
        return self._apply("and", f, g)

    def or_(self, f: int, g: int) -> int:
        return self._apply("or", f, g)

    def xor_(self, f: int, g: int) -> int:
        return self._apply("xor", f, g)

    def and_limited(self, f: int, g: int, node_limit: int) -> Optional[int]:
        """Conjunction ABORTING MID-CONSTRUCTION once the manager has grown
        by node_limit extra nodes (ref: and_rec_limited, bdd_mgr.h:39 — a
        post-hoc check would pay the full blowup the limit exists to
        prevent)."""
        self._node_budget = self.nr_nodes() + node_limit
        try:
            return self.and_(f, g)
        except _NodeBudgetExceeded:
            return None
        finally:
            self._node_budget = None

    def ite(self, f: int, g: int, h: int) -> int:
        """if f then g else h (ref: ite_rec)."""
        if f == TRUE:
            return g
        if f == FALSE:
            return h
        if g == h:
            return g
        if g == TRUE and h == FALSE:
            return f
        if g == FALSE and h == TRUE:
            return self.negate(f)
        key = ("ite", f, g, h)
        r = self._cache.get(key)
        if r is not None:
            return r
        vs = [self.var[x] for x in (f, g, h) if not is_terminal(x)]
        v = min(vs)

        def co(x, bit):
            if is_terminal(x) or self.var[x] != v:
                return x
            return self.hi[x] if bit else self.lo[x]

        r = self._mk(
            v,
            self.ite(co(f, 0), co(g, 0), co(h, 0)),
            self.ite(co(f, 1), co(g, 1), co(h, 1)),
        )
        self._cache[key] = r
        return r

    def multi_and(self, fs: Sequence[int]) -> int:
        r = TRUE
        for f in fs:
            r = self.and_(r, f)
        return r

    # ----------------------------------------------------------------- rebase
    def rebase(self, f: int, var_map: Dict[int, int]) -> int:
        """Copy f with variables renumbered (must be order-preserving,
        ref: bdd_mgr.h:104-159). Memoized per call — rebuilding the sorted
        var_map tuple at every node was O(N * M log M) and bloated the
        shared cache with M-tuple keys."""
        memo: Dict[int, int] = {}

        def rec(n: int) -> int:
            if is_terminal(n):
                return n
            r = memo.get(n)
            if r is None:
                r = self._mk(
                    var_map[self.var[n]], rec(self.lo[n]), rec(self.hi[n])
                )
                memo[n] = r
            return r

        return rec(f)

    # ----------------------------------------------------------- constraint builders
    def simplex(self, variables: Sequence[int]) -> int:
        """Exactly-one (ref: bdd_mgr.h simplex builder)."""
        return self.cardinality(variables, 1, 1)

    def at_most(self, variables: Sequence[int], k: int) -> int:
        return self.cardinality(variables, 0, k)

    def at_least(self, variables: Sequence[int], k: int) -> int:
        return self.cardinality(variables, k, len(variables))

    def at_most_one(self, variables: Sequence[int]) -> int:
        return self.at_most(variables, 1)

    def cardinality(self, variables: Sequence[int], lb: int, ub: int) -> int:
        """lb <= sum x_i <= ub over sorted variables (bottom-up DP — one
        recursion frame per variable would hit Python's recursion limit for
        n around 1000)."""
        vs = sorted(variables)
        n = len(vs)

        def entry(i: int, cnt: int, nxt) -> int:
            if cnt > ub or cnt + (n - i) < lb:
                return FALSE
            if i == n:
                return TRUE if lb <= cnt <= ub else FALSE
            return nxt.get(cnt, FALSE)

        nxt: Dict[int, int] = {}
        for i in range(n - 1, -1, -1):
            cur: Dict[int, int] = {}
            for cnt in range(0, i + 1):
                if cnt > ub or cnt + (n - i) < lb:
                    continue
                cur[cnt] = self._mk(
                    vs[i],
                    entry(i + 1, cnt, nxt),
                    entry(i + 1, cnt + 1, nxt),
                )
            nxt = cur
        return entry(0, 0, nxt)

    def all_equal(self, variables: Sequence[int]) -> int:
        """All variables take the same value (ref: bdd_mgr.h all_equal)."""
        vs = sorted(variables)
        n = len(vs)

        if n == 0:
            return TRUE
        # iterative bottom-up chains (recursion depth would be n frames)
        zero = TRUE
        one = TRUE
        for i in range(n - 1, 0, -1):
            zero = self._mk(vs[i], zero, FALSE)
            one = self._mk(vs[i], FALSE, one)
        return self._mk(vs[0], zero, one)

    # -------------------------------------------------------------- analysis
    def evaluate(self, f: int, assignment: Sequence[int]) -> bool:
        while not is_terminal(f):
            f = self.hi[f] if assignment[self.var[f]] else self.lo[f]
        return f == TRUE

    def support(self, f: int) -> List[int]:
        seen = set()
        out = set()
        stack = [f]
        while stack:
            n = stack.pop()
            if is_terminal(n) or n in seen:
                continue
            seen.add(n)
            out.add(self.var[n])
            stack.extend((self.lo[n], self.hi[n]))
        return sorted(out)

    def nr_solutions(self, f: int) -> int:
        """Accepting assignments over the support (iterative: children
        always have smaller node ids than their parents, so one ascending-id
        pass computes all memo entries without recursion depth limits)."""
        support = self.support(f)
        pos = {v: i for i, v in enumerate(support)}
        d = len(support)
        if is_terminal(f):
            return 2 ** d if f == TRUE else 0
        reach = set()
        stack = [f]
        while stack:
            n = stack.pop()
            if is_terminal(n) or n in reach:
                continue
            reach.add(n)
            stack.extend((self.lo[n], self.hi[n]))
        memo: Dict[int, int] = {}

        def child_count(c: int, depth: int) -> int:
            if c == TRUE:
                return 2 ** (d - depth)
            if c == FALSE:
                return 0
            return 2 ** (pos[self.var[c]] - depth) * memo[c]

        for n in sorted(reach):
            p = pos[self.var[n]]
            memo[n] = child_count(self.lo[n], p + 1) + child_count(
                self.hi[n], p + 1
            )
        return 2 ** pos[self.var[f]] * memo[f]

    def nodes_of(self, f: int) -> int:
        seen = set()
        stack = [f]
        while stack:
            n = stack.pop()
            if is_terminal(n) or n in seen:
                continue
            seen.add(n)
            stack.extend((self.lo[n], self.hi[n]))
        return len(seen)

    # ------------------------------------------------------------ collection
    def add_to_collection(self, f: int, collection: BddCollection) -> int:
        """Export one function into the flat collection (ref: bdd_collection
        add_bdd(node_ref), bdd_collection.h:150-151)."""
        assert not is_terminal(f)
        order: List[int] = []
        seen = set()
        stack = [f]
        while stack:
            n = stack.pop()
            if is_terminal(n) or n in seen:
                continue
            seen.add(n)
            order.append(n)
            stack.extend((self.lo[n], self.hi[n]))
        order.sort(key=lambda n: self.var[n])
        if order[0] != f:
            order.remove(f)
            order.insert(0, f)
        idx = {n: i for i, n in enumerate(order)}
        nodes = [
            (
                self.var[n],
                self.lo[n] if is_terminal(self.lo[n]) else idx[self.lo[n]],
                self.hi[n] if is_terminal(self.hi[n]) else idx[self.hi[n]],
            )
            for n in order
        ]
        return collection.add_bdd(nodes)

    def from_collection(self, collection: BddCollection, bdd_nr: int) -> int:
        local = collection.local_nodes(bdd_nr)
        mapped: List[int] = [0] * len(local)
        for i in range(len(local) - 1, -1, -1):
            v, lo, hi = local[i]
            lo_m = lo if lo < 0 else mapped[lo]
            hi_m = hi if hi < 0 else mapped[hi]
            mapped[i] = self._mk(v, lo_m, hi_m)
        return mapped[0]
