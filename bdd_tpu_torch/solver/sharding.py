"""Partitions of a BDD collection over the shards of a sharded solve, and
the dense sharded solve (counterpart of bdd_tpu/solver/sharding.py).

BDDs are partitioned into contiguous blocks balanced by node count, in the
order of each BDD's median variable, so that every shard gets a tight window
of variables; ``refine_partition_mincut`` moves boundary BDDs to shrink the
set of variables that several shards share (the rows the consensus must
carry across shards). These host functions (numpy) are copies of the JAX
package's, held to them line for line by ``tests/test_torch_standalone.py``.

The dense sharded solve (``ShardedBdds``, ``shard_collection``,
``init_sharded_state``, ``ShardedSolver``) runs the dense backend
(``solver/dense.py``) on one shard a rank of a ``torch.distributed`` process
group: every shard's dense arrays are padded to the common (H, W, L), and the
per-variable delta pair [V + 1] of each half-sweep is summed across the ranks
(``uniform_sharded.all_reduce``) before the sweep takes it; the JAX package
stacks the shards on a device axis under ``shard_map`` and sums with one
``lax.psum``. With no process group the solver is one shard on its device.
Every rank builds the host (numpy) arrays of all D shards, in the same
deterministic way and with no collective, and uploads only its own.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from bdd_tpu_torch.bdd.collection import BddCollection
from bdd_tpu_torch.solver import dense as dn
from bdd_tpu_torch.solver.flatten import ARC_BOT, densify, flatten_collection


def partition_bdds(collection: BddCollection, nr_shards: int) -> List[List[int]]:
    """Partition of BDD numbers balanced by node count, contiguous in the
    MEDIAN-VARIABLE order. Collection order follows constraint order, which
    need not track the variable ordering (e.g. grid MRFs list all unary
    simplexes first) — splitting in variable order gives every shard a tight
    variable window (~V/D with a BFS/Cuthill ordering), which the windowed
    exchange plans exploit to keep per-shard sort volume ~E/D. The MEDIAN
    (not minimum) is the robust centroid: on GM/QAP-like instances a
    marginalization/product constraint touches one early assignment variable
    plus a dense block of late product variables — min-var order interleaves
    those BDDs by the assignment id and destroys locality, while median-var
    order clusters them by their product block (the assignment variables
    become the two-region plans' shared stretcher set). For chain/grid BDDs
    with contiguous levels both keys give the same order."""
    nb = collection.nr_bdds()
    sizes = [collection.nr_bdd_nodes(b) for b in range(nb)]

    def median_var(b: int) -> int:
        vs = sorted(collection.level_variables(b))
        return vs[len(vs) // 2]

    order = sorted(range(nb), key=lambda b: (median_var(b), b))
    total = sum(sizes)
    target = total / nr_shards
    parts: List[List[int]] = []
    cur: List[int] = []
    acc = 0.0
    for b in order:
        cur.append(b)
        acc += sizes[b]
        # leave enough bdds so every remaining shard gets at least one
        if (
            acc >= target
            and len(parts) < nr_shards - 1
            and (nb - len(cur) - sum(len(p) for p in parts))
            >= (nr_shards - len(parts) - 1)
        ):
            parts.append(sorted(cur))
            cur = []
            acc = 0.0
    parts.append(sorted(cur))
    while len(parts) < nr_shards:  # degenerate: fewer bdds than shards
        parts.append([])
    assert sum(len(p) for p in parts) == nb
    return parts


def shared_width(
    collection: BddCollection, parts: List[List[int]]
) -> int:
    """Cost of a partition under the split exchange plans: the shared-region
    width sum_{v shared} max_s cnt[v, s] — each shard's sort must carry one
    column per shared variable's max-over-shards BDD count (BENCH.md
    'shared-count-profile floor'). Private variables cost nothing extra."""
    D = len(parts)
    V = 0
    vars_of = []
    for b in range(collection.nr_bdds()):
        vs = np.asarray(sorted(collection.level_variables(b)), dtype=np.int64)
        vars_of.append(vs)
        if len(vs):
            V = max(V, int(vs[-1]) + 1)
    cnt = np.zeros((V, D), dtype=np.int32)
    for s, p in enumerate(parts):
        for b in p:
            cnt[vars_of[b], s] += 1
    nnz = (cnt > 0).sum(axis=1)
    return int(cnt.max(axis=1)[nnz >= 2].sum())


def partition_cost(
    collection: BddCollection, parts: List[List[int]]
) -> tuple:
    """(N_est, E_est, J) host-side cost proxy of a partition under the split
    exchange plans. N_est = max-shard private column count + shared width
    (the per-shard sort volume); E_est = max-shard layer count (the bucket
    slots every shard pads to). Measured on the real chip (BENCH round-5
    A/B): T_shard moves ~1e-8 s per element of EITHER, so J = N_est + E_est
    ranks partitions without building geometries."""
    D = len(parts)
    V = 0
    vars_of = []
    layers = np.zeros(collection.nr_bdds(), dtype=np.int64)
    for b in range(collection.nr_bdds()):
        vs = np.asarray(sorted(collection.level_variables(b)), dtype=np.int64)
        vars_of.append(vs)
        layers[b] = len(vs)
        if len(vs):
            V = max(V, int(vs[-1]) + 1)
    cnt = np.zeros((V, D), dtype=np.int32)
    for s, p in enumerate(parts):
        for b in p:
            cnt[vars_of[b], s] += 1
    shared = (cnt > 0).sum(axis=1) >= 2
    w_shared = int(cnt.max(axis=1)[shared].sum())
    priv = np.where(shared[:, None], 0, cnt).sum(axis=0)  # per-shard
    priv_max = int(priv.max()) if D else 0
    e_max = max(
        (int(layers[list(p)].sum()) if len(p) else 0) for p in parts
    )
    n_est = priv_max + w_shared
    return n_est, e_max, n_est + e_max


def refine_partition_mincut(
    collection: BddCollection,
    parts: List[List[int]],
    balance: float = 0.05,
    max_passes: int = 8,
) -> List[List[int]]:
    """KL-style greedy refinement of a BDD partition minimizing the
    shared-variable width (see ``shared_width``) under a node-count balance
    constraint (no shard above (1+balance) x average).

    The block partition (``partition_bdds``) is locality-aware only through
    the variable ORDER; on quadratically-coupled families (QAP, GM) many
    BDDs straddle any contiguous split. This pass moves boundary BDDs to
    the shard where most of their variables already live, deterministically
    (fixed scan order, strict-improvement moves), until a pass makes no
    move. Cost per pass is O(sum_b |vars(b)| * touched shards) in vectorized
    numpy. (SURVEY §7 'multi-host BDD partitioning'; the reference's
    two-way CPU/GPU split, bdd_multi_parallel_mma_base.cu:268-455, has no
    partitioner to port — it splits by a fixed hop threshold.)"""
    nb = collection.nr_bdds()
    D = len(parts)
    if D <= 1 or nb == 0:
        return parts
    vars_of = [
        np.asarray(sorted(collection.level_variables(b)), dtype=np.int64)
        for b in range(nb)
    ]
    sizes = np.asarray(
        [collection.nr_bdd_nodes(b) for b in range(nb)], dtype=np.float64
    )
    V = max((int(v[-1]) for v in vars_of if len(v)), default=-1) + 1
    cnt = np.zeros((V, D), dtype=np.int32)
    shard_of = np.empty(nb, dtype=np.int32)
    for s, p in enumerate(parts):
        for b in p:
            shard_of[b] = s
            cnt[vars_of[b], s] += 1
    shard_nodes = np.zeros(D)
    shard_len = np.zeros(D, dtype=np.int64)
    for s, p in enumerate(parts):
        shard_nodes[s] = sizes[list(p)].sum() if len(p) else 0.0
        shard_len[s] = len(p)
    hi = (1.0 + balance) * sizes.sum() / D

    def contribs(rows: np.ndarray) -> np.ndarray:
        # per-variable shared-width contribution of a [k, D] count block
        return np.where((rows > 0).sum(axis=1) >= 2, rows.max(axis=1), 0)

    # scan order: BDDs with many variables first (largest potential gain)
    order = sorted(range(nb), key=lambda b: (-len(vars_of[b]), b))
    for _ in range(max_passes):
        moved = 0
        for b in order:
            vb = vars_of[b]
            if len(vb) == 0:
                continue
            s = int(shard_of[b])
            if shard_len[s] <= 1:
                continue  # never empty a shard
            rows = cnt[vb]
            base = contribs(rows)
            if int(base.sum()) == 0:
                continue  # fully private: no move can help
            cand = np.nonzero(rows.sum(axis=0) > 0)[0]
            best_gain, best_t = 0, -1
            for t in cand:
                t = int(t)
                if t == s or shard_nodes[t] + sizes[b] > hi:
                    continue
                rows2 = rows.copy()
                rows2[:, s] -= 1
                rows2[:, t] += 1
                gain = int(base.sum() - contribs(rows2).sum())
                if gain > best_gain or (
                    gain == best_gain and best_t >= 0 and t < best_t
                ):
                    best_gain, best_t = gain, t
            if best_t >= 0 and best_gain > 0:
                cnt[vb, s] -= 1
                cnt[vb, best_t] += 1
                shard_nodes[s] -= sizes[b]
                shard_nodes[best_t] += sizes[b]
                shard_len[s] -= 1
                shard_len[best_t] += 1
                shard_of[b] = best_t
                moved += 1
        if moved == 0:
            break
    return [
        sorted(int(b) for b in np.nonzero(shard_of == s)[0])
        for s in range(D)
    ]


def _subcollection(collection: BddCollection, bdd_nrs: List[int]) -> BddCollection:
    out = BddCollection()
    for b in bdd_nrs:
        out.add_bdd(collection.local_nodes(b))
    return out


# ------------------------------------------------------- the dense sharding
_GEOM_KEYS = ("node_valid", "layer_local", "lo_kind", "lo_next", "hi_kind", "hi_next",
              "layer_valid", "layer_var", "alpha", "num_bdds_per_var")


class ShardedBdds(NamedTuple):
    """Per-shard dense geometry and bookkeeping. ``arrays``: every shard's
    padded host arrays (numpy, keyed by the ``DenseGeom`` field names; alpha
    float64), the leaves that the JAX package stacks on its device axis;
    ``geoms``: the shards built on the device (None for the others)."""

    arrays: tuple  # per shard {field: numpy array}
    geoms: tuple  # per shard DenseGeom or None
    flats: tuple  # per-shard FlatBdds (host)
    denses: tuple  # per-shard DenseBdds (host)
    parts: tuple  # per-shard bdd number lists (into the original collection)
    num_bdds_per_var_global: np.ndarray


def shard_collection(collection: BddCollection, nr_vars: int, nr_shards: int,
                     nr_primal_vars: Optional[int] = None, dtype=torch.float32,
                     device="cuda", shards: Optional[Sequence[int]] = None) -> ShardedBdds:
    """The dense arrays of ``nr_shards`` shards (sharding.py:249-323 of the
    JAX package): each shard's BDDs flattened and densified on their own,
    padded to the common (H, W, L), alpha from the whole collection's
    per-variable counts. An empty shard holds one placeholder BDD whose
    layers are invalid: it neither receives nor emits delta mass and adds 0
    to the bound. ``shards``: the shards to build on ``device`` (default
    all)."""
    parts = partition_bdds(collection, nr_shards)
    flats, denses, dummy = [], [], []
    for p in parts:
        sub = _subcollection(collection, p)
        dummy.append(sub.nr_bdds() == 0)
        if sub.nr_bdds() == 0:
            sub.add_bdd([(0, -1, -1)])
        flats.append(flatten_collection(sub, nr_vars, nr_primal_vars))
        denses.append(densify(flats[-1]))

    # global per-variable BDD counts (placeholder BDDs excluded)
    counts = np.zeros(nr_vars, dtype=np.int32)
    for p, f in zip(parts, flats):
        if len(p) > 0:
            counts += f.num_bdds_per_var
    counts_safe = np.maximum(counts, 1)

    H = max(d.H for d in denses)
    W = max(d.W for d in denses)
    L = max(d.L for d in denses)
    arrays = []
    for d, is_dummy in zip(denses, dummy):
        alpha = np.zeros((H, L))
        lvar = np.full((H, L), nr_vars, dtype=np.int32)
        lvalid = np.zeros((H, L), dtype=bool)
        if not is_dummy:
            lvar[: d.H, : d.L] = d.layer_var
            lvalid[: d.H, : d.L] = d.layer_valid
        alpha[lvalid] = 1.0 / counts_safe[lvar[lvalid]]
        nvalid = np.zeros((H, W), dtype=bool)
        nvalid[: d.H, : d.W] = d.node_valid
        llocal = np.full((H, W), L, dtype=np.int32)
        llocal[: d.H, : d.W] = np.where(d.layer_local == d.L, L, d.layer_local)
        kinds_next = {}
        for side in ("lo", "hi"):
            kind = np.full((H, W), ARC_BOT, dtype=np.int32)
            nxt = np.full((H, W), W, dtype=np.int32)
            kind[: d.H, : d.W] = getattr(d, f"{side}_kind")
            nxt[: d.H, : d.W] = np.where(getattr(d, f"{side}_next") == d.W, W,
                                         getattr(d, f"{side}_next"))
            kinds_next[f"{side}_kind"], kinds_next[f"{side}_next"] = kind, nxt
        arrays.append(dict(node_valid=nvalid, layer_local=llocal, **kinds_next,
                           layer_valid=lvalid, layer_var=lvar, alpha=alpha,
                           num_bdds_per_var=counts))
    return ShardedBdds(arrays=tuple(arrays), geoms=_geoms(arrays, dtype, device, shards),
                       flats=tuple(flats), denses=tuple(denses),
                       parts=tuple(tuple(p) for p in parts), num_bdds_per_var_global=counts)


def _geoms(arrays, dtype, device, shards: Optional[Sequence[int]]) -> tuple:
    """The device geometries of the ``shards`` asked for (default all)."""
    want = range(len(arrays)) if shards is None else shards
    return tuple(dn.geom_from_arrays(*(a[k] for k in _GEOM_KEYS), dtype=dtype, device=device)
                 if d in want else None for d, a in enumerate(arrays))


def init_sharded_state(sharded: ShardedBdds, objective, shard: int) -> dn.SolverState:
    """The initial state of one built shard (one slice of the JAX package's
    stacked [D, H, L] / [D, H, W] state): the objective split by the global
    per-variable BDD counts, a clean backward run."""
    geom = sharded.geoms[shard]
    a = sharded.arrays[shard]
    obj = np.asarray(objective, dtype=np.float64)
    counts = np.maximum(sharded.num_bdds_per_var_global, 1)
    lvar, lvalid = a["layer_var"], a["layer_valid"]
    hi = np.zeros(lvar.shape)
    hi[lvalid] = obj[lvar[lvalid]] / counts[lvar[lvalid]]
    hi = torch.from_numpy(hi).to(geom.device, geom.dtype)
    lo = torch.zeros_like(hi)
    return dn.SolverState(lo=lo, hi=hi, def_mm=torch.zeros_like(hi),
                          cft=dn.backward_run(geom, lo, hi))


class ShardedSolver:
    """One rank's shard of the dense sharded solve (the JAX package's
    ``ShardedSolver`` over a device mesh): every rank constructs it with the
    same arguments and calls its methods in the same order (each runs
    collectives). Cross-shard communication: one all_reduce of the
    per-variable delta pair [V + 1, 2] per half-sweep; the bound is the sum
    across the ranks of the local bounds after distributing the reduced
    deltas. With no process group: one shard on ``device``. ``like``: the
    ``sharded`` of an earlier solver of the same collection and ranks
    (another float type), whose partition and host arrays it takes in place
    of building them again."""

    default_block_size = 10

    def __init__(self, collection: BddCollection, nr_vars: int, objective, group=None,
                 nr_primal_vars: Optional[int] = None, dtype=torch.float32,
                 omega: float = 0.5, device="cuda", like: Optional[ShardedBdds] = None) -> None:
        from bdd_tpu_torch.solver.layout import resolve_device
        from bdd_tpu_torch.solver.uniform_sharded import Comm

        self.comm = Comm(group)
        device = resolve_device(device)
        if self.comm.backend == "nccl" and device.type != "cuda":
            raise ValueError("an NCCL process group needs the solver on a card")
        r = self.comm.rank
        if like is None:
            self.sharded = shard_collection(collection, nr_vars, self.comm.size, nr_primal_vars,
                                            dtype=dtype, device=device, shards=[r])
        else:
            if len(like.parts) != self.comm.size or len(like.num_bdds_per_var_global) != nr_vars:
                raise ValueError(f"a sharding of {len(like.parts)} shards and "
                                 f"{len(like.num_bdds_per_var_global)} variables for "
                                 f"{self.comm.size} ranks and {nr_vars} variables")
            self.sharded = like._replace(geoms=_geoms(like.arrays, dtype, device, [r]))
        self.geom = self.sharded.geoms[r]
        self.state = init_sharded_state(self.sharded, objective, r)
        self.dtype, self.device, self.omega = dtype, device, omega

    def _delta(self, def_mm: torch.Tensor):
        """The per-variable delta pair of this shard's deferred marginals,
        summed across the ranks."""
        from bdd_tpu_torch.solver.uniform_sharded import all_reduce

        d = all_reduce(self.comm, dn.delta_sums(self.geom, def_mm))
        return d[:, 0], d[:, 1]

    def iteration(self) -> None:
        geom, omega = self.geom, self.omega
        state, cfr = dn.forward_iteration(geom, self.state, omega,
                                          delta=self._delta(self.state.def_mm))
        self.state = dn.backward_iteration(geom, state, omega, cfr,
                                           delta=self._delta(state.def_mm))

    def iteration_block(self, n: int) -> None:
        for _ in range(n):
            self.iteration()

    def lower_bound(self) -> float:
        """The global bound after distributing the reduced deferred deltas:
        this shard's root costs summed in float64, summed across the ranks."""
        from bdd_tpu_torch.solver.uniform_sharded import all_reduce

        geom = self.geom
        cft = dn.update_costs(geom, self.state, *self._delta(self.state.def_mm)).cft
        local = torch.where(geom.node_valid[0], cft[0], 0.0).to(torch.float64).sum()
        return float(all_reduce(self.comm, local).to(self.dtype))

    def lower_bound_with_deferred(self) -> float:
        return self.lower_bound()
