"""Multi-process runtime of the sharded solve: the process group, and
checkpoints of a sharded solve (counterpart of bdd_tpu/utils/multihost.py).

The JAX package runs one controller per host over a global device mesh. The
port runs one process per device (a rank), each holding one shard of the
BDDs, joined by a ``torch.distributed`` process group: NCCL between cards,
gloo on the CPU (and gloo where two ranks share one card, which NCCL
refuses). ``initialize`` wraps ``init_process_group``; the sharded solver
reads the group and never starts one by itself.

A checkpoint is the JAX package's file: a pickle of {"kind", "state": the
leaves of the state, each stacked over the shards} (leaves lo..., hi...,
def_mm... per bucket [D, H, B], then cft... per bucket [D, H, P, B]), so a
file written by either package loads in the other at the same number of
shards and the same instance. The state is gathered to every rank, rank 0
writes, and all ranks meet at a barrier before any may read the file.
"""
from __future__ import annotations

import datetime
import os
import pickle
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, platform: str = "cuda",
               backend: Optional[str] = None, timeout_s: float = 600.0) -> None:
    """Join the process group of a multi-process run. With no address, the
    environment gives it (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK, as ``torchrun`` sets them); else ``coordinator_address``
    ("host:port"), ``num_processes`` and ``process_id``. ``platform``:
    "cuda" (backend NCCL, the rank's card made the current device: LOCAL_RANK,
    else the rank modulo the cards) or "cpu" (gloo); ``backend`` overrides
    the backend (gloo for ranks that share one card)."""
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"unknown platform {platform!r}: 'cuda' or 'cpu'")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("platform 'cuda' requested but torch.cuda.is_available() is False")
    if backend is None:
        backend = "nccl" if platform == "cuda" else "gloo"
    kw = {}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit address needs num_processes and process_id")
        kw = dict(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                  rank=int(process_id))
    if platform == "cuda":
        rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _stacked_leaves(solver):
    """The state's leaves stacked over the shards: every rank's flat state
    gathered, then cut per bucket as the JAX package's pytree leaves are."""
    geom = solver.geom
    lo, hi, mm, cft = (solver.comm.all_gather(x) for x in solver.state.flat)
    D = solver.comm.size
    per = [[geom.per_bucket(x[d]) for d in range(D)] for x in (lo, hi, mm)]
    nodes = [geom.per_bucket_nodes(cft[d]) for d in range(D)]
    leaves = []
    for rows in per:
        for k in range(len(geom.buckets)):
            leaves.append(np.stack([rows[d][k].cpu().numpy() for d in range(D)]))
    for k in range(len(geom.buckets)):
        leaves.append(np.stack([np.ascontiguousarray(nodes[d][k].cpu().numpy())
                                for d in range(D)]))
    return leaves


def save_sharded(solver, path: str) -> None:
    """Checkpoint a ``ShardedUniformSolver``'s dual state: every rank's shard
    gathered, rank 0 writes the JAX package's format, and all ranks wait at
    a barrier for the file."""
    leaves = _stacked_leaves(solver)
    if solver.comm.rank == 0:
        with open(path, "wb") as fh:
            pickle.dump({"kind": "ShardedUniformSolver", "state": leaves}, fh)
    solver.comm.barrier()


def load_sharded(solver, path: str) -> None:
    """Restore a sharded dual state: every rank reads the file and takes its
    own shard of every leaf; ValueError when the leaves' count or stacked
    shapes differ from the solver's (another instance, shard count or
    layout)."""
    from bdd_tpu_torch.solver.layout import state_from_buckets

    with open(path, "rb") as fh:
        blob = pickle.load(fh)
    arrays = blob["state"]
    st = solver.state
    template = [*st.lo, *st.hi, *st.def_mm, *st.cft]
    D, r = solver.comm.size, solver.comm.rank
    if len(arrays) != len(template) or any(
        np.shape(a) != (D, *t.shape) for a, t in zip(arrays, template)
    ):
        raise ValueError(
            f"checkpoint does not match the solver's state structure ({len(arrays)} vs "
            f"{len(template)} leaves / stacked shape mismatch) — geometry/backend mismatch")
    geom = solver.geom
    nb = len(st.lo)

    def t(xs):
        return [torch.from_numpy(np.array(x[r])).to(geom.device, geom.dtype) for x in xs]

    solver.state = state_from_buckets(geom, *(t(arrays[k * nb:(k + 1) * nb]) for k in range(4)))
