"""Partitions of a BDD collection over the shards of a sharded solve: the
host part of bdd_tpu/solver/sharding.py (lines 35-238), numpy only.

BDDs are partitioned into contiguous blocks balanced by node count, in the
order of each BDD's median variable, so that every shard gets a tight window
of variables; ``refine_partition_mincut`` moves boundary BDDs to shrink the
set of variables that several shards share (the rows the consensus must
carry across shards). The functions are copies of the JAX package's, held to
them line for line by ``tests/test_torch_standalone.py``. The rest of that
file, the dense ``ShardedSolver`` over ``jax_solver.py``, belongs with the
dense backend (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

from typing import List

import numpy as np

from bdd_tpu_torch.bdd.collection import BddCollection


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
