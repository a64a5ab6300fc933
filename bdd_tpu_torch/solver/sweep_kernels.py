"""CUDA sweep kernels of the uniform backend (counterpart of
bdd_tpu/solver/pallas_uniform.py).

Two levels of wrapper over the kernels of ``csrc/uniform_sweep.cu``
(``uniform_forward``, ``uniform_backward``, each with a body for buckets of
up to 32 slots, one for wide buckets, one a block a column for wider buckets
(``layout.body_of``: from ``layout.HUGE_FROM`` slots on, rows in shared
memory), and for buckets whose rows do not fit a block (``layout.huge_fits``)
its cluster form, a cluster of blocks a column, where a cluster holds them
(``layout.cluster_fits``) and their columns are many, and its L2 form for
the rest; the run-only entry takes the L2 form for all of them; see the
design notes there):

* ``forward_iteration_cuda`` / ``backward_iteration_cuda`` take a whole
  ``UniformGeom`` and flat tensors and run the half-sweep of every bucket: ONE
  launch over the narrow buckets, a second one over the wide buckets and one
  over each huge form's, each where the layout has any. The iteration
  uses these. Shapes and types were fixed when the layout was built, so a
  call checks only what it is handed, allocates the four outputs and makes
  one ctypes call per launch.
* ``bucket_forward_iteration_cuda`` / ``bucket_backward_iteration_cuda`` keep
  the signature of the Pallas wrappers: one bucket, [H, B] tensors, optional
  per-layer ``alpha`` and ``omega``. They launch the same kernels over a table
  of one bucket, with every argument validated.

* ``backward_run_cuda`` / ``bucket_backward_run_cuda`` are the run-only
  entry of the backward kernel (``uniform_backward_run``): the
  costs-to-terminal of given costs with no cost update, the port's form of
  ``bdd_tpu.solver.uniform.bucket_backward_run``. Same bodies, same tables,
  one launch per body.

On CUDA tensors a wrapper launches its kernel or raises. On CPU tensors it
runs the plain torch twins of ``uniform.py``. Every width runs a kernel (a
narrow one if it is a power of two), for any H and in float32 and float64;
there is no fallback.

Frontier tensors are [H, P, B] at every one-bucket wrapper and flat in the
storage order of ``UniformGeom.per_bucket_nodes`` at the fused ones (a wide
or huge bucket stores [H, B, P]; a one-bucket wrapper that is handed another
layout of such a frontier copies it into that one first).

``LAUNCHES`` counts kernel launches, one key per kernel and body
(``uniform_forward`` is the narrow body's launch, ``uniform_forward_wide`` the
wide body's, ``uniform_forward_huge`` the huge body's,
``uniform_forward_huge_cluster`` its cluster form's,
``uniform_forward_huge_l2`` its L2 form's). The twins never count here
(``uniform.TWIN_SWEEP_CALLS`` and ``uniform.PLAIN_RUN_CALLS`` count them).

``L2_WAIT`` counts the L2 body's hop-barrier wait: while a ``torch.profiler``
records, an L2 launch takes the body's counting entry (``_count``), which
adds, block by block, thread 0's SM cycles spent at the column's hop
barriers and the block's SM cycles from start to end. Where the counting
entries hold fewer blocks an SM than the body's own (which G comes from),
the launch runs uncounted. ``l2_wait_cycles`` reads the sums, and
``L2_COUNTED`` counts by entry the launches that took the counting entry
(``LAUNCHES`` counts them under ``_huge_l2`` with the others).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from bdd_tpu_torch import _build
from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.solver.layout import (
    NARROW_P,
    BucketGeom,
    LaunchPlan,
    UniformGeom,
    huge_scratch,
    l2_occupancy,
    launch_plan,
    plan_scratch_bytes,
)

SUPPORTED_P = (1, 2, 4, 8, 16, 32)  # the narrow body's instantiations
KERNELS = ("uniform_forward", "uniform_backward")  # the half-sweeps
RUN = "uniform_backward_run"  # the backward kernel's entry without the cost update
WIDE = "_wide"  # suffix of the wide body's entries and of its key in LAUNCHES
HUGE = "_huge"  # the same for the huge body (a block a column, rows in shared memory)
HUGE_CLUSTER = "_huge_cluster"  # its cluster form (rows past a block's, within a cluster's)
HUGE_L2 = "_huge_l2"  # the same for its L2 form (rows past a cluster's shared memory)
BODIES = ("", WIDE, HUGE, HUGE_CLUSTER, HUGE_L2)
LAUNCHES = {kernel + body: 0 for kernel in KERNELS + (RUN,) for body in BODIES}
L2_ENTRIES = KERNELS + (RUN,)  # the rows of an L2_WAIT tensor
# per device: int64 [3, 2], a row an entry of L2_ENTRIES: (barrier wait, block cycles)
L2_WAIT: Dict[torch.device, torch.Tensor] = {}
L2_COUNTED = {kernel: 0 for kernel in L2_ENTRIES}  # launches of the counting entries
_COUNTING_FITS: Dict[tuple, bool] = {}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in L2_COUNTED:
        L2_COUNTED[k] = 0
    for t in L2_WAIT.values():
        t.zero_()


def _l2_wait(device: torch.device) -> torch.Tensor:
    t = L2_WAIT.get(device)
    if t is None:
        t = L2_WAIT[device] = torch.zeros((len(L2_ENTRIES), 2), dtype=torch.int64, device=device)
    return t


def l2_wait_cycles() -> Dict[str, Tuple[int, int]]:
    """(barrier wait, block cycles) of the L2 body's counted launches by
    entry, summed over the devices (SM cycles; a read on the host)."""
    out = {k: (0, 0) for k in L2_ENTRIES}
    for t in L2_WAIT.values():
        for k, (wait, cycles) in zip(L2_ENTRIES, t.tolist()):
            out[k] = (out[k][0] + wait, out[k][1] + cycles)
    return out


def _counting_fits(itemsize: int, threads: int, device: torch.device) -> bool:
    """Whether the L2 body's counting entries hold as many blocks an SM as
    its own entries, from which the plan took G."""
    key = (itemsize, threads, device)
    if key not in _COUNTING_FITS:
        _COUNTING_FITS[key] = (l2_occupancy(itemsize, threads, device, counting=True)
                               >= l2_occupancy(itemsize, threads, device))
    return _COUNTING_FITS[key]


def _suffix(dtype: torch.dtype) -> str:
    try:
        return _SUFFIX[dtype]
    except KeyError:
        raise TypeError(f"sweep kernels take float32 or float64, got {dtype}") from None


def _check_widths(shapes) -> None:
    """Narrow buckets need an instantiation of their width; the wide and huge
    bodies take any wider P."""
    for P, H, B in shapes:
        if P <= NARROW_P and P not in SUPPORTED_P:
            raise ValueError(
                f"no sweep kernel for bucket shape (P={P}, H={H}, B={B}); instantiated P: "
                f"{SUPPORTED_P}, and any P above {NARROW_P} in the wide and huge bodies"
            )


def _check_all(named, shapes) -> None:
    dev, dt = named[0][1].device, named[0][1].dtype
    for (name, t), shape in zip(named, shapes):
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {dt} on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _launcher(kernel: str, plan: LaunchPlan, arcs, lo, hi, din_lo, din_hi, alpha, omega,
              frontier, outs, scratch=None):
    """A closure that queues ``kernel`` on the current stream (the narrow
    buckets' launch, then the wide buckets', the huge buckets', the cluster
    body's and the L2 body's, each where the plan has blocks for it; the run
    entry's cluster and L2 launches by its own route) and raises on a launch
    error. It holds its tensors alive and does not count in ``LAUNCHES``;
    ``launch.counts`` names the key of ``LAUNCHES`` of every launch a call
    makes. ``scratch``:
    the L2 body's (:func:`layout.huge_scratch`): the key rows, which the
    forward reads, and the partials and counters of the column barriers,
    which every entry needs where the plan splits a column. A launch made
    while a profiler records takes the L2 body's counting entry, where it
    fits (``L2_WAIT``), and counts itself in ``L2_COUNTED``."""
    suffix = _suffix(lo.dtype)
    if isinstance(omega, torch.Tensor) and omega.dim() > 0:
        omega_arr, omega_val = omega, 0.0
    else:
        omega_arr, omega_val = None, float(omega)
    lib = _build.load()

    def ptr(t):  # the run entry has no deltas, no incoming frontier, no cost outputs
        return None if t is None else t.data_ptr()

    buffers = (
        arcs.data_ptr(), lo.data_ptr(), hi.data_ptr(), ptr(din_lo), ptr(din_hi), ptr(alpha),
        ptr(omega_arr), omega_val, ptr(frontier), *(ptr(o) for o in outs),
        torch.cuda.current_stream(lo.device).cuda_stream,
    )
    calls = []
    if plan.nr_blocks:
        calls.append((kernel, (
            plan.table.data_ptr(), plan.nr_buckets, plan.nr_blocks, plan.tile, plan.pmax,
            plan.smem_bytes, *buffers)))
    if plan.wide_blocks:
        calls.append((kernel + WIDE, (
            plan.wide_table.data_ptr(), plan.nr_wide, plan.wide_blocks, plan.wide_warps,
            plan.wide_warp_bytes, plan.wide_smem_bytes, *buffers)))
    if plan.huge_blocks:
        smem = plan.huge_smem_forward if kernel == "uniform_forward" else plan.huge_smem_backward
        calls.append((kernel + HUGE, (
            plan.huge_table.data_ptr(), plan.nr_huge, plan.huge_blocks, plan.huge_threads,
            plan.huge_pmax, smem, *buffers)))
    # the run-only entry takes its own route (layout.run_body_of)
    if plan.run_cluster_blocks if kernel == RUN else plan.cluster_blocks:
        smem = (plan.cluster_smem_forward if kernel == "uniform_forward"
                else plan.cluster_smem_backward)
        calls.append((kernel + HUGE_CLUSTER, (
            plan.cluster_table.data_ptr(), plan.nr_cluster, plan.cluster_blocks,
            plan.cluster_threads, plan.cluster_size, plan.cluster_pmax, smem, *buffers)))
    if kernel == RUN:
        l2 = (plan.run_l2_table, plan.nr_run_l2, plan.run_l2_blocks, plan.run_l2_split,
              plan.run_l2_columns)
    else:
        l2 = (plan.l2_table, plan.nr_l2, plan.l2_blocks, plan.l2_split, plan.l2_columns)
    table, nr_l2, l2_blocks, split, columns = l2
    if l2_blocks:
        if scratch is None:
            raise ValueError(f"{kernel}: the L2 body's launch needs its scratch "
                             f"(layout.huge_scratch)")
        base = scratch.data_ptr()
        parts, counters, _ = plan_scratch_bytes(plan, lo.element_size())
        calls.append((kernel + HUGE_L2, (
            table.data_ptr(), nr_l2, l2_blocks, plan.l2_threads, split, columns, *buffers[:-1],
            base, base + parts, base + counters, buffers[-1])))
    calls = [(name, getattr(lib, f"{name}_{suffix}"), args) for name, args in calls]
    keep = (plan, arcs, lo, hi, din_lo, din_hi, alpha, omega_arr, frontier, outs, scratch)
    counting = False
    if l2_blocks:  # the L2 call is the last one
        wait = _l2_wait(lo.device)
        acc = wait.data_ptr() + L2_ENTRIES.index(kernel) * wait.stride(0) * wait.element_size()
        # asked here and not in a traced launch: the card's first answer
        # loads the counting entries
        counting = _counting_fits(lo.element_size(), plan.l2_threads, lo.device)

    def launch() -> None:
        todo = calls
        if counting and torch._C._autograd._profiler_enabled():
            name, _, args = calls[-1]
            todo = calls[:-1] + [(name, getattr(lib, f"{name}_count_{suffix}"),
                                  args[:-1] + (acc, args[-1]))]
            L2_COUNTED[kernel] += 1
        for name, fn, args in todo:
            rc = fn(*args)
            if rc != 0:
                raise RuntimeError(
                    f"{name}_{suffix} launch failed (code {rc}) over buckets {plan.shapes}"
                )

    launch.keep = keep
    launch.counts = tuple(name for name, _, _ in calls)
    return launch


def _launch_counted(launch) -> None:
    launch()
    for name in launch.counts:
        LAUNCHES[name] += 1


def _fresh_outputs(lo, frontier):
    return (torch.empty_like(lo), torch.empty_like(lo), torch.empty_like(lo),
            torch.empty_like(frontier))


# ------------------------------------------------------- all buckets, fused
def prepare_fused_launch(kernel: str, geom: UniformGeom, lo, hi, frontier, omega,
                         din_lo, din_hi, plan: LaunchPlan = None, alpha=None):
    """Check one launch of ``kernel`` over all buckets of ``geom`` on flat
    tensors and allocate its outputs. Returns (launch, outs); ``launch()``
    does not count (timing and comparisons call it directly). ``plan``
    replaces ``geom.plan`` (another prefetch depth, body or split over the
    same buckets; it gets a scratch of its own where its L2 body needs one).
    ``omega``: a scalar or a flat [E] tensor; ``alpha``: flat [E] per-layer
    weights in place of ``geom.alpha`` (the learned solver's)."""
    plan = plan or geom.plan
    _check_widths(plan.shapes)
    E, N = plan.E, plan.N
    if isinstance(omega, torch.Tensor) and omega.dim() > 0:
        omega = omega.to(lo.dtype).expand(E).contiguous()
    alpha = geom.alpha if alpha is None else alpha
    _check_flat(geom, (("lo", lo, E), ("hi", hi, E), ("din_lo", din_lo, E),
                       ("din_hi", din_hi, E), ("alpha", alpha, E), ("frontier", frontier, N)))
    outs = _fresh_outputs(lo, frontier)
    scratch = geom.huge_scratch if plan is geom.plan else huge_scratch(plan, lo.dtype, lo.device)
    return _launcher(kernel, plan, geom.arcs, lo, hi, din_lo, din_hi, alpha, omega,
                     frontier, outs, scratch), outs


def _fused(kernel: str, twin, geom: UniformGeom, lo, hi, frontier, omega, din_lo, din_hi,
           alpha):
    if lo.device.type == "cpu":
        return uf.sweep_per_bucket(twin, geom, lo, hi, frontier, omega, din_lo, din_hi, alpha)
    launch, outs = prepare_fused_launch(kernel, geom, lo, hi, frontier, omega, din_lo, din_hi,
                                        alpha=alpha)
    _launch_counted(launch)
    return outs


def _check_flat(geom: UniformGeom, named) -> None:
    for name, t, n in named:
        if (t.dtype != geom.dtype or t.device != geom.device or t.dim() != 1
                or t.shape[0] != n or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}; expected a contiguous "
                f"{geom.dtype} [{n}] on {geom.device}"
            )


def prepare_run_launch(geom: UniformGeom, lo, hi, plan: LaunchPlan = None):
    """Check one launch of the run-only backward entry over all buckets of
    ``geom`` on flat costs and allocate its output. Returns (launch, cft);
    ``launch()`` does not count."""
    plan = plan or geom.plan
    _check_widths(plan.shapes)
    _check_flat(geom, (("lo", lo, plan.E), ("hi", hi, plan.E)))
    cft = torch.empty(plan.N, dtype=lo.dtype, device=lo.device)
    scratch = geom.huge_scratch if plan is geom.plan else huge_scratch(plan, lo.dtype, lo.device)
    return _launcher(RUN, plan, geom.arcs, lo, hi, None, None, None, 0.0, None,
                     (None, None, None, cft), scratch), cft


def backward_run_cuda(geom: UniformGeom, lo, hi) -> torch.Tensor:
    """Costs-to-terminal of the flat costs (lo, hi [E]) of every bucket ->
    cft [N], freshly allocated: one launch per body on the card, the plain
    ``uniform.bucket_backward_run`` bucket by bucket on CPU tensors."""
    if lo.device.type == "cpu":
        return geom.flatten_nodes([
            uf.bucket_backward_run(g, l, h)
            for g, l, h in zip(geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))
        ])
    launch, cft = prepare_run_launch(geom, lo, hi)
    _launch_counted(launch)
    return cft


def forward_iteration_cuda(geom: UniformGeom, lo, hi, cft, omega, din_lo, din_hi, alpha=None):
    """Forward half-sweep of every bucket on flat tensors (lo, hi, din_* [E];
    cft [N]; omega a scalar or [E]; alpha [E], default ``geom.alpha``) ->
    (lo, hi, def_mm [E], cfr [N]), freshly allocated."""
    return _fused("uniform_forward", uf.bucket_forward_iteration, geom, lo, hi, cft, omega,
                  din_lo, din_hi, alpha)


def backward_iteration_cuda(geom: UniformGeom, lo, hi, cfr, omega, din_lo, din_hi, alpha=None):
    """Backward half-sweep of every bucket on flat tensors -> (lo, hi, def_mm
    [E], cft [N]), freshly allocated."""
    return _fused("uniform_backward", uf.bucket_backward_iteration, geom, lo, hi, cfr, omega,
                  din_lo, din_hi, alpha)


# ---------------------------------------------------------------- one bucket
def _node_storage(P: int, frontier: torch.Tensor) -> torch.Tensor:
    """The [H, P, B] frontier of one bucket in the layout the kernels read:
    itself for a narrow bucket, [H, B, P] for a wide one (a copy unless it is
    the transposed view of such storage already)."""
    return frontier if P <= NARROW_P else frontier.transpose(1, 2).contiguous()


def _node_view(P: int, stored: torch.Tensor) -> torch.Tensor:
    return stored if P <= NARROW_P else stored.transpose(1, 2)


def _check_bucket_geometry(g: BucketGeom, lo) -> None:
    if g.arcs.device != lo.device or g.arcs.dtype != torch.uint8 or not g.arcs.is_contiguous():
        raise ValueError(f"bucket geometry {g.arcs.dtype} on {g.arcs.device}; costs on {lo.device}")
    if g.arcs.data_ptr() % 16:
        raise ValueError("bucket geometry records are not 16-byte aligned")


def prepare_launch(kernel: str, g: BucketGeom, lo, hi, frontier, omega, din_lo, din_hi,
                   alpha=None):
    """Validate one launch of ``kernel`` ("uniform_forward"/"uniform_backward")
    on one bucket and allocate its outputs. Returns (launch, outs);
    ``launch()`` does not count."""
    if lo.device.type != "cuda":
        raise ValueError(f"{kernel}: tensors on {lo.device}; the kernel needs CUDA")
    H, P, B = g.H, g.P, g.B
    _check_widths([(P, H, B)])
    _suffix(lo.dtype)
    din_lo, din_hi = din_lo.to(lo.dtype), din_hi.to(lo.dtype)
    alpha = g.alpha if alpha is None else alpha
    alpha = torch.as_tensor(alpha, dtype=lo.dtype, device=lo.device).expand(H, B).contiguous()
    if isinstance(omega, torch.Tensor) and omega.dim() > 0:
        omega = omega.to(lo.dtype).expand(H, B).contiguous()
    if tuple(frontier.shape) != (H, P, B):
        raise ValueError(f"frontier: shape {tuple(frontier.shape)}, expected {(H, P, B)}")
    stored = _node_storage(P, frontier)
    costs = [("lo", lo), ("hi", hi), ("frontier", stored), ("din_lo", din_lo),
             ("din_hi", din_hi), ("alpha", alpha)]
    _check_all(costs, [(H, B), (H, B), tuple(stored.shape), (H, B), (H, B), (H, B)])
    _check_bucket_geometry(g, lo)
    plan = launch_plan([(P, H, B)], lo.dtype, lo.device)
    outs = _fresh_outputs(lo, stored)
    launch = _launcher(kernel, plan, g.arcs, lo, hi, din_lo, din_hi, alpha, omega, stored, outs,
                       huge_scratch(plan, lo.dtype, lo.device))
    return launch, outs[:3] + (_node_view(P, outs[3]),)


def _launch(kernel: str, g: BucketGeom, lo, hi, frontier, omega, din_lo, din_hi, alpha):
    launch, outs = prepare_launch(kernel, g, lo, hi, frontier, omega, din_lo, din_hi, alpha)
    _launch_counted(launch)
    return outs


def bucket_forward_iteration_cuda(
    g: BucketGeom, lo, hi, cft, omega, din_lo, din_hi, alpha=None
) -> Tuple[torch.Tensor, ...]:
    """Forward half-sweep of one bucket -> (lo, hi, def_mm, cfr)."""
    if lo.device.type == "cpu":
        return uf.bucket_forward_iteration(g, lo, hi, cft, omega, din_lo, din_hi, alpha)
    return _launch("uniform_forward", g, lo, hi, cft, omega, din_lo, din_hi, alpha)


def bucket_backward_iteration_cuda(
    g: BucketGeom, lo, hi, cfr, omega, din_lo, din_hi, alpha=None
) -> Tuple[torch.Tensor, ...]:
    """Backward half-sweep of one bucket -> (lo, hi, def_mm, cft)."""
    if lo.device.type == "cpu":
        return uf.bucket_backward_iteration(g, lo, hi, cfr, omega, din_lo, din_hi, alpha)
    return _launch("uniform_backward", g, lo, hi, cfr, omega, din_lo, din_hi, alpha)


def bucket_backward_run_cuda(g: BucketGeom, lo, hi) -> torch.Tensor:
    """Costs-to-terminal cft [H, P, B] of one bucket's costs (lo, hi): one
    launch of the run-only backward entry over a table of one bucket."""
    if lo.device.type == "cpu":
        return uf.bucket_backward_run(g, lo, hi)
    H, P, B = g.H, g.P, g.B
    _check_widths([(P, H, B)])
    _suffix(lo.dtype)
    _check_all([("lo", lo), ("hi", hi)], [(H, B), (H, B)])
    _check_bucket_geometry(g, lo)
    plan = launch_plan([(P, H, B)], lo.dtype, lo.device)
    stored = torch.empty((H, P, B) if P <= NARROW_P else (H, B, P), dtype=lo.dtype,
                         device=lo.device)
    _launch_counted(_launcher(RUN, plan, g.arcs, lo, hi, None, None, None, 0.0, None,
                              (None, None, None, stored),
                              huge_scratch(plan, lo.dtype, lo.device)))
    return _node_view(P, stored)
