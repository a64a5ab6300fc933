"""The sharded uniform solve on ``torch.distributed`` (counterpart of
bdd_tpu/solver/uniform_sharded.py).

BDDs are partitioned into blocks (``sharding.partition_bdds``, optionally
refined to share fewer variables); every shard lays out the SAME bucket
structure (global bucket keys, column counts padded to a common count, rows
padded to the class height, empty buckets where a shard lacks a key, one
set of pooled column-packing heights), so every rank gets the same launch
plan and the shards' state leaves stack as the JAX package's do. The JAX
package runs one controller over a mesh (``shard_map`` + ``lax.psum``);
here each process (a rank) holds one shard on its device and runs the
port's sweep kernels on it, and the exchange's ``delta_reduce`` hook sums
the per-variable deltas [V + 1, 2] across the ranks with an ``all_reduce``
on the process group: NCCL between cards, gloo on the CPU. With no process
group the solver is one shard on its device, as JAX is on a one-device host;
it never starts a group by itself.

``plan_family``: "split" and "auto" carry across the ranks only the rows of
the variables that two or more shards touch (every rank's other rows are
already the whole sum), in one order all ranks share; "windowed" and
"global" carry every row. The JAX package's sort-based exchange plans are
not carried over: the port has only the segment exchange.

Every rank builds the host (numpy) arrays of all D shards, in the same
deterministic way, and uploads only its own: the rounding's layer view and
the learned solver's global view need every shard's layer arrays anyway, and
the build needs no collective.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bdd_tpu_torch.solver import layout
from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.solver.layout import ARC_BOT, UniformHost, UniformState, state_from_flat
from bdd_tpu_torch.solver.sharding import (
    partition_bdds,
    partition_cost,
    refine_partition_mincut,
    shared_width,
)

PARTITIONS = ("block", "mincut", "auto")
PLAN_FAMILIES = ("auto", "split", "windowed", "global")


# ------------------------------------------------------------ process group
class Comm:
    """The collectives of a sharded solve over a process group (default:
    the world); one rank of size 1 without a group, whose collectives do
    nothing (a group of one still runs them through its backend). Every call
    is made by every rank in the same order. Sums run in the backend's
    order, which may differ from a single device's (the last bits of a float
    sum)."""

    def __init__(self, group=None) -> None:
        self.group = group
        self.active = dist.is_initialized()
        if self.active:
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = str(dist.get_backend(group))
        else:
            world = int(os.environ.get("WORLD_SIZE", "1"))
            if world > 1:
                raise RuntimeError(
                    f"WORLD_SIZE={world} but no process group is initialized: call "
                    "bdd_tpu_torch.utils.multihost.initialize() first")
            self.size, self.rank, self.backend = 1, 0, None
        self.calls = 0  # collectives issued
        self.bytes = 0  # their payload

    def _count(self, t: torch.Tensor) -> None:
        self.calls += 1
        self.bytes += t.numel() * t.element_size()

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` across the ranks, in place."""
        if self.active:
            self._count(t)
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[D, *t.shape]: every rank's ``t``."""
        if not self.active:
            return t[None]
        self._count(t)
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return torch.stack(out)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.active:
            self._count(t)
            dist.broadcast(t, src, group=self.group)
        return t

    def barrier(self) -> None:
        if self.active:
            dist.barrier(group=self.group)


class _AllReduce(torch.autograd.Function):
    """Sum across the ranks; its gradient is the sum of the ranks'
    gradients (the transpose of a sum that every rank receives)."""

    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return comm.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.all_reduce_(g.clone())


class _AllGather(torch.autograd.Function):
    """[D, ...] of every rank's tensor; the gradient of a rank's own tensor
    is its row of the summed gradients."""

    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return comm.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        return None, comm.all_reduce_(g.contiguous().clone())[comm.rank]


def all_reduce(comm: Comm, x: torch.Tensor) -> torch.Tensor:
    """Sum across the ranks (a new tensor); differentiable."""
    if not comm.active:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduce.apply(comm, x)
    return comm.all_reduce_(x.clone())


def all_gather(comm: Comm, x: torch.Tensor) -> torch.Tensor:
    """[D, ...] of every rank's ``x``; differentiable."""
    if torch.is_grad_enabled() and x.requires_grad and comm.active:
        return _AllGather.apply(comm, x)
    return comm.all_gather(x)


# ------------------------------------------------------------ shard layouts
def _pad_bucket(b: dict, B: int, H: int, nr_vars: int, packed: bool) -> dict:
    """A bucket's arrays padded to H rows and B columns (``_pad_bucket`` of
    the JAX package): padded rows and columns are wholly invalid, so the
    sweeps pass through them; a packed layout's padded roots stay False."""
    H0, P, B0 = b["node_valid"].shape
    dH, dB = H - H0, B - B0
    if dH == 0 and dB == 0:
        return b

    def pad3(x, fill):
        return np.pad(x, ((0, dH), (0, 0), (0, dB)), constant_values=fill)

    def pad2(x, fill):
        return np.pad(x, ((0, dH), (0, dB)), constant_values=fill)

    return dict(
        node_valid=pad3(b["node_valid"], False), lo_kind=pad3(b["lo_kind"], ARC_BOT),
        lo_slot=pad3(b["lo_slot"], 0), hi_kind=pad3(b["hi_kind"], ARC_BOT),
        hi_slot=pad3(b["hi_slot"], 0), layer_valid=pad2(b["layer_valid"], False),
        layer_var=pad2(b["layer_var"], nr_vars), alpha=pad2(b["alpha"], 0.0),
        layer_bdd=pad2(b["layer_bdd"], -1),
        root_mask=pad2(b["root_mask"], False) if packed else None,
        bdd_of_col=np.pad(b["bdd_of_col"], (0, dB), constant_values=-1),
        depths=np.pad(b["depths"], (0, dB), constant_values=0),
    )


def _empty_bucket(P: int, H: int, B: int, nr_vars: int, packed: bool) -> dict:
    """A bucket of a key the shard lacks (``_empty_bucket`` of the JAX
    package): B columns, all invalid."""
    return dict(
        node_valid=np.zeros((H, P, B), bool), lo_kind=np.full((H, P, B), ARC_BOT, np.int32),
        lo_slot=np.zeros((H, P, B), np.int32), hi_kind=np.full((H, P, B), ARC_BOT, np.int32),
        hi_slot=np.zeros((H, P, B), np.int32), layer_valid=np.zeros((H, B), bool),
        layer_var=np.full((H, B), nr_vars, np.int32), alpha=np.zeros((H, B)),
        layer_bdd=np.full((H, B), -1, np.int64),
        root_mask=np.zeros((H, B), bool) if packed else None,
        bdd_of_col=np.full(B, -1, np.int64), depths=np.zeros(B, np.int32),
    )


def choose_partition(collection, D: int, partition: str = "auto") -> List[List[int]]:
    """The BDDs of each of D shards (``build_shard_geoms`` of the JAX
    package, uniform_sharded.py:104-129): 'block' = contiguous median-variable
    blocks; 'mincut' = block refined to share fewer variables; 'auto' =
    refine only where the block partition's shared width is over 15% of the
    incidences, and keep the refinement only where it lowers the partition's
    cost (``partition_cost``). Any other value raises ValueError (the JAX
    package takes it silently as 'auto')."""
    if partition not in PARTITIONS:
        raise ValueError(f"unknown partition {partition!r}: one of {PARTITIONS}")
    parts = partition_bdds(collection, D)
    if partition != "block" and D > 1:
        w_block = shared_width(collection, parts)
        total_inc = sum(len(collection.level_variables(b)) for b in range(collection.nr_bdds()))
        if partition == "mincut" or w_block > 0.15 * max(total_inc, 1):
            refined = refine_partition_mincut(collection, parts)
            if partition == "mincut":
                parts = refined
            elif partition_cost(collection, refined)[2] < partition_cost(collection, parts)[2]:
                parts = refined
    return parts


@dataclasses.dataclass
class ShardLayout:
    """The D shards of a collection: per shard its BDDs (``parts``), its
    unpacked bucket arrays (numpy, ``raw``; None for a shard without BDDs)
    and its padded bucket arrays (``buckets``: every shard the same keys and
    shapes), the whole collection's per-variable BDD counts, the variables
    two or more shards touch (``shared``, sorted), and the device layouts
    (``hosts``) of the shards that were asked for (None elsewhere)."""

    parts: List[List[int]]
    raw: List[Optional[List[dict]]]
    buckets: List[List[dict]]
    counts: np.ndarray
    shared: np.ndarray
    packed: bool
    hosts: List[Optional[UniformHost]]
    nr_vars: int
    nr_primal_vars: int
    nr_bdds: int

    @property
    def D(self) -> int:
        return len(self.parts)

    def view_buckets(self) -> List[dict]:
        """Per bucket every shard's columns side by side: the global view's
        arrays (``global_view`` of the JAX package)."""
        out = []
        for k in range(len(self.buckets[0]) if self.buckets else 0):
            bs = [sh[k] for sh in self.buckets]
            v = {}
            for key in bs[0]:
                if bs[0][key] is None:
                    v[key] = None
                else:
                    v[key] = np.concatenate([b[key] for b in bs], axis=bs[0][key].ndim - 1)
            out.append(v)
        return out


def build_shard_geoms(collection, nr_vars: int, D: int, dtype=torch.float32,
                      pack: Optional[bool] = None, nr_primal_vars: Optional[int] = None,
                      plan_family: str = "auto", partition: str = "auto", device="cuda",
                      shards: Optional[Sequence[int]] = None,
                      like: Optional[ShardLayout] = None) -> ShardLayout:
    """The D shards' layouts (uniform_sharded.py:75-312): every shard laid
    out by ``layout.flatten_buckets`` with the whole collection's counts (so
    alpha is 1 / the global count, and a variable the shard lacks is an empty
    segment of its sums), packed (float32 by default) with heights chosen
    once from every shard's depths, then padded to the global bucket keys:
    (P, H) unpacked, (P, depth tier) packed, sorted; per key the rows to the
    tallest shard's and the columns to the widest shard's count (a huge
    bucket too: it is not padded to 128 columns, only to the common count);
    a key a shard lacks is an empty bucket. ``shards``: the shards to build
    on ``device`` (default all); ``like``: an earlier layout of the same
    collection and D (another float type) whose partition and unpacked
    arrays to take in place of choosing and flattening again. Unknown
    ``partition`` or ``plan_family`` values raise ValueError."""
    if plan_family not in PLAN_FAMILIES:
        raise ValueError(f"unknown plan_family {plan_family!r}: one of {PLAN_FAMILIES}")
    if nr_primal_vars is None:
        nr_primal_vars = nr_vars
    if like is not None:
        if like.D != D or like.nr_vars != nr_vars:
            raise ValueError(f"a layout of {like.D} shards and {like.nr_vars} variables for "
                             f"{D} shards and {nr_vars} variables")
        parts, counts, raw = like.parts, like.counts, like.raw
    else:
        parts = choose_partition(collection, D, partition)
        counts = np.zeros(nr_vars, dtype=np.int32)
        for b in range(collection.nr_bdds()):
            for v in collection.level_variables(b):
                counts[v] += 1
        raw = [layout.flatten_buckets(collection, nr_vars, counts_override=counts,
                                      keep_bdds=p)[0] if len(p) > 0 else None for p in parts]
    unpacked = raw
    if pack is None:
        pack = dtype == torch.float32
    packed = False
    if pack:
        pooled: dict = {}
        for bs in unpacked:
            for b in bs or ():
                deps = np.asarray(b["depths"])
                pooled.setdefault(int(b["node_valid"].shape[1]), []).extend(
                    int(x) for x in deps[deps > 0])
        if pooled:
            caps = layout.choose_pack_caps({p: np.asarray(v) for p, v in pooled.items()})
            raw = [layout._pack_buckets(bs, nr_vars, caps) if bs is not None else None
                   for bs in unpacked]
            packed = True

    def key_of(b):
        H, P, _ = b["node_valid"].shape
        if packed:
            return (P, -1 - int(H > layout.PACK_H_CAP))
        return (P, H)

    keys_of = [[key_of(b) for b in bs] if bs else [] for bs in raw]
    all_keys = sorted({k for ks in keys_of for k in ks})
    H_of: dict = {}
    B_of: dict = {}
    for bs, ks in zip(raw, keys_of):
        for b, k in zip(bs or (), ks):
            H, _, B = b["node_valid"].shape
            H_of[k] = max(H_of.get(k, 0), H)
            B_of[k] = max(B_of.get(k, 0), B)
    buckets = []
    for bs, ks in zip(raw, keys_of):
        shard = []
        for k in all_keys:
            if k in ks:
                shard.append(_pad_bucket(bs[ks.index(k)], B_of[k], H_of[k], nr_vars, packed))
            else:
                shard.append(_empty_bucket(k[0], H_of[k], B_of[k], nr_vars, packed))
        buckets.append(shard)
    touched = np.zeros((D, nr_vars + 1), dtype=bool)
    for d, shard in enumerate(buckets):
        for b in shard:
            touched[d, b["layer_var"][b["layer_valid"]]] = True
    shared = np.nonzero(touched[:, :nr_vars].sum(axis=0) >= 2)[0].astype(np.int64)
    want = range(D) if shards is None else shards
    hosts = [layout._build_host(buckets[d], counts, nr_vars, nr_primal_vars, len(parts[d]),
                                dtype, device) if d in want else None for d in range(D)]
    return ShardLayout(parts=parts, raw=unpacked, buckets=buckets, counts=counts, shared=shared,
                       packed=packed, hosts=hosts, nr_vars=nr_vars,
                       nr_primal_vars=nr_primal_vars, nr_bdds=collection.nr_bdds())


# ------------------------------------------------------------------- solver
class _ShardedLayerView:
    """The layer-indexed view of the host rounding over all shards: numpy
    arrays over the concatenated per-(shard, bucket) [H*B] layers."""

    def __init__(self, lay: ShardLayout) -> None:
        self.nr_vars = lay.nr_vars
        self.nr_primal_vars = lay.nr_primal_vars
        self.layer_var = np.concatenate(
            [b["layer_var"].ravel() for sh in lay.buckets for b in sh]).astype(np.int32)
        self._valid = np.concatenate(
            [b["layer_valid"].ravel() for sh in lay.buckets for b in sh]).astype(bool)
        self.num_bdds_per_var = lay.counts

    def valid_layer_mask(self) -> np.ndarray:
        return self._valid


class ShardedUniformSolver:
    """One rank's share of a sharded uniform solve, with the duck interface
    of ``UniformSolver`` that ``run_solver``, the host rounding and the outer
    loops drive. Every rank constructs it with the same arguments; every
    method is then called by every rank in the same order (each runs
    collectives). ``geom`` / ``state``: this rank's shard on its device;
    bounds, min-marginals and views are global (the same on every rank).
    ``like``: the ``layout`` of an earlier solver of the same collection
    (another float type), whose partition and unpacked arrays it takes."""

    default_block_size = 25

    def __init__(self, collection, nr_vars: int, objective, group=None,
                 nr_primal_vars: Optional[int] = None, dtype=torch.float32, omega: float = 0.5,
                 pack: Optional[bool] = None, plan_family: str = "auto",
                 partition: str = "auto", device="cuda",
                 like: Optional[ShardLayout] = None) -> None:
        self.comm = Comm(group)
        D, r = self.comm.size, self.comm.rank
        device = layout.resolve_device(device)
        if self.comm.backend == "nccl" and device.type != "cuda":
            raise ValueError("an NCCL process group needs the solver on a card")
        self.layout = build_shard_geoms(
            collection, nr_vars, D, dtype=dtype, pack=pack, nr_primal_vars=nr_primal_vars,
            plan_family=plan_family, partition=partition, device=device, shards=[r],
            like=like)
        self.host = self.layout.hosts[r]
        self.geom = self.host.geom
        self.dtype, self.device = dtype, device
        self.omega = omega
        # the rows of the [V + 1, 2] sums that cross the ranks; None: all
        self.rows = None
        if plan_family in ("auto", "split"):
            self.rows = torch.from_numpy(self.layout.shared).to(device)
        self.state = uf.init_uniform_state(self.host, objective)
        self.f = _ShardedLayerView(self.layout)
        self._view_host = None

    # --------------------------------------------------------------- hooks
    def delta_reduce(self, dsum: torch.Tensor) -> torch.Tensor:
        """The exchange's hook: the per-variable sums [V + 1, 2] summed
        across the ranks, over the shared rows only ("split", "auto") or all
        of them. Differentiable (the learned solver's gradients)."""
        if not self.comm.active:
            return dsum
        if self.rows is None:
            return all_reduce(self.comm, dsum)
        if self.rows.numel() == 0:
            return dsum
        return dsum.index_copy(0, self.rows, all_reduce(self.comm, dsum.index_select(0, self.rows)))

    def sum_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Any tensor summed across the ranks (a new tensor)."""
        return all_reduce(self.comm, x)

    def clock(self) -> float:
        """Rank 0's monotonic clock, the same on every rank: the termination
        loop's time limit then stops every rank after the same block."""
        t = torch.tensor([time.monotonic()], dtype=torch.float64, device=self.device)
        return float(self.comm.broadcast_(t)[0])

    # ---------------------------------------------------------------- dual
    def iteration(self) -> None:
        self.state = uf.iteration(self.geom, self.state, self.omega,
                                  delta_reduce=self.delta_reduce)

    def iteration_block(self, n: int) -> None:
        self.state = uf.iterations(self.geom, self.state, n, self.omega,
                                   delta_reduce=self.delta_reduce)

    def _bound(self, state: UniformState) -> torch.Tensor:
        """The global bound of a state's costs-to-terminal: this shard's root
        costs summed in float64, summed across the ranks, cast to the
        solver's float type (0-dim)."""
        lb = torch.zeros((), dtype=torch.float64, device=self.device)
        for g, c in zip(self.geom.buckets, state.cft):
            lb = lb + torch.where(g.roots, c[:, 0, :], 0.0).to(torch.float64).sum()
        return all_reduce(self.comm, lb).to(self.dtype)

    def lower_bound(self) -> float:
        """The bound after distributing the deferred deltas (the JAX
        package's sharded bound is that one too)."""
        dist_state = uf.distribute_delta(self.geom, self.state, delta_reduce=self.delta_reduce)
        return float(self._bound(dist_state))

    def lower_bound_with_deferred(self) -> float:
        return self.lower_bound()

    def distribute_delta(self) -> None:
        self.state = uf.distribute_delta(self.geom, self.state, delta_reduce=self.delta_reduce)

    def min_marginals(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-(shard, bucket) [H*B] min marginals, concatenated shard after
        shard (the layer view's order), the same on every rank."""
        mm = uf.min_marginals_all(self.geom, self.state)
        m0 = torch.cat([a.reshape(-1) for a, _ in mm])
        m1 = torch.cat([b.reshape(-1) for _, b in mm])
        both = self.comm.all_gather(torch.stack([m0, m1]))  # [D, 2, E]
        both = both.cpu().numpy()
        return both[:, 0].reshape(-1), both[:, 1].reshape(-1)

    def bdds_solution(self) -> Tuple[torch.Tensor, ...]:
        """This shard's per-bucket [H, B] int8 argmin-path choices."""
        return uf.bdds_solution(self.geom, self.state)

    def update_costs(self, lo_per_var, hi_per_var) -> None:
        def per_var(x):
            x = np.append(np.asarray(x, np.float64), 0.0)  # sentinel slot V
            return torch.as_tensor(x, device=self.device).to(self.dtype)

        self.state = uf.update_costs_per_var(self.geom, self.state, per_var(lo_per_var),
                                             per_var(hi_per_var))

    # ------------------------------------------------------- learned (DOGE)
    def global_view(self) -> UniformHost:
        """A one-device layout of the whole collection, every shard's columns
        side by side per bucket (the JAX package's ``global_view``): valid
        for every per-column computation (min-marginals, smoothed solutions,
        per-BDD bounds, features); its exchange is the whole collection's.
        Built once, on this rank's device."""
        if self._view_host is None:
            lay = self.layout
            self._view_host = layout._build_host(
                lay.view_buckets(), lay.counts, lay.nr_vars, lay.nr_primal_vars, lay.nr_bdds,
                self.dtype, self.device)
        return self._view_host

    def _to_view(self, stacked: torch.Tensor, nodes: bool) -> torch.Tensor:
        """[D, E] (or [D, N]) shard tensors in the global view's flat order."""
        geom, D = self.geom, self.comm.size
        parts = []
        per = [geom.per_bucket_nodes(x) if nodes else geom.per_bucket(x) for x in stacked]
        for k, g in enumerate(geom.buckets):
            xs = [per[d][k] for d in range(D)]
            parts.append(torch.cat(xs, dim=-1))
        if nodes:
            return self.global_view().geom.flatten_nodes(parts)
        return layout.flatten(parts)

    def view_state(self, state: Optional[UniformState] = None) -> UniformState:
        """A state (default the current one) in the global view's layout,
        gathered from every rank; differentiable."""
        s = self.state if state is None else state
        lo, hi, mm, cft = (all_gather(self.comm, x) for x in s.flat)
        view = self.global_view().geom
        return state_from_flat(view, self._to_view(lo, False), self._to_view(hi, False),
                               self._to_view(mm, False), self._to_view(cft, True))

    def stack_layers(self, view_flat: torch.Tensor) -> torch.Tensor:
        """This shard's block of a per-layer tensor [E] of the global view
        (the JAX package splits it into [D, H, B]; a rank keeps its own)."""
        r, D = self.comm.rank, self.comm.size
        out = []
        for g, x in zip(self.geom.buckets, self.global_view().geom.per_bucket(view_flat)):
            out.append(x.reshape(g.H, D, g.B)[:, r])
        return layout.flatten(out)

    def isotropic_alphas(self) -> torch.Tensor:
        """This shard's isotropic weights [E] (1 / the global count)."""
        return self.geom.alpha

    def omega_from_per_var(self, omega_vec: torch.Tensor) -> torch.Tensor:
        """A per-variable [V + 1] vector as this shard's per-layer omegas [E]
        (differentiable: the gradients sum over a variable's layers)."""
        ex = self.geom.exchange
        return torch.where(ex.valid, omega_vec[ex.ids], 0.0)

    def learned_iteration_block(self, alpha, omega, n: int) -> None:
        """n learned iterations with this shard's per-layer (alpha, omega)
        [E]; differentiable through the sum across the ranks."""
        from bdd_tpu_torch.solver import learned as ln

        self.state = ln.learned_iterations(self.geom, self.state, alpha, omega, n,
                                           delta_reduce=self.delta_reduce)
