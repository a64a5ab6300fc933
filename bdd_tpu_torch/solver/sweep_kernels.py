"""CUDA sweep kernels of the uniform backend (counterpart of
bdd_tpu/solver/pallas_uniform.py).

Two levels of wrapper over the kernels of ``csrc/uniform_sweep.cu``
(``uniform_forward``, ``uniform_backward``, each with a body for buckets of
up to 32 slots, one for wide buckets, one a block a column for wider buckets
(from ``layout.HUGE_FROM`` slots on, rows in shared memory), and for buckets
whose rows do not fit a block (``layout.huge_fits``) its cluster form, a
cluster of blocks a column, where a cluster holds them
(``layout.cluster_fits``) and their columns are many, and its L2 form for
the rest; the run-only entry takes the L2 form for all of them;
``layout.route`` gives each bucket its body; see the design notes there):

* ``forward_iteration_cuda`` / ``backward_iteration_cuda`` take a whole
  ``UniformGeom`` and flat tensors and run the half-sweep of every bucket: ONE
  launch over the narrow buckets, a second one over the wide buckets and one
  over each huge form's, each where the layout has any. The iteration
  uses these. Shapes and types were fixed when the layout was built, so a
  call checks only what it is handed, allocates the four outputs and makes
  one ctypes call.
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

A launch is one record of the plan (``layout.BodyLaunch``), and a call of an
entry hands the library all of them at once (``_build.Launch``, made once per
plan and scratch, and ``_build.Buffers``): one ctypes call a half-sweep.

Two bodies have a counting form, which adds, block by block, the SM cycles
its blocks spend at the body's barriers (the L2 body: thread 0's at the
column's hop barriers; the shared-memory huge body: each warp's from its
arrival to its release at each hop's block barriers) and their SM cycles
from start to end: ``L2_WAIT`` and ``HUGE_WAIT`` sum them by device and
entry, ``l2_wait_cycles`` and ``huge_wait_cycles`` read the sums. While a
``torch.profiler`` records, a launch of such a body takes its counting form
once in every ``COUNT_EVERY[body]`` profiled launches of its entry, the first
included: every L2 launch, one huge launch in HUGE_COUNT_EVERY (its counting
form runs slower than its own, PERF.md section 6, so a traced slice takes it
only that often). ``PROFILED`` and ``COUNTED`` count by (body, entry) the
profiled launches and those that took the counting form. Where a counting
form holds fewer blocks an SM than the body's own (by which the plan placed
the body), the launch runs uncounted.

``HUGE_RING`` counts by entry the launches of the shared-memory huge body
that take its ring form (the hops of its record; ``LAUNCHES`` counts them
under ``_huge`` with the others).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from bdd_tpu_torch import _build
from bdd_tpu_torch.solver import uniform as uf
from bdd_tpu_torch.solver.layout import (
    NARROW_P,
    SUFFIXES,
    BodyLaunch,
    BucketGeom,
    LaunchPlan,
    UniformGeom,
    block_occupancy,
    huge_scratch,
    launch_plan,
)

SUPPORTED_P = (1, 2, 4, 8, 16, 32)  # the narrow body's instantiations
KERNELS = ("uniform_forward", "uniform_backward")  # the half-sweeps
RUN = "uniform_backward_run"  # the backward kernel's entry without the cost update
# the suffixes of the wide body's entries and of its key in LAUNCHES, of the
# huge body's (a block a column, rows in shared memory), of its cluster form
# (rows past a block's, within a cluster's) and of its L2 form (rows past a
# cluster's shared memory)
BODIES = SUFFIXES
WIDE, HUGE, HUGE_CLUSTER, HUGE_L2 = SUFFIXES[1:]
LAUNCHES = {kernel + body: 0 for kernel in KERNELS + (RUN,) for body in BODIES}
L2_ENTRIES = KERNELS + (RUN,)  # the rows of an L2_WAIT or HUGE_WAIT tensor
# per device: int64 [3, 2], a row an entry of L2_ENTRIES: (barrier wait, block cycles)
L2_WAIT: Dict[torch.device, torch.Tensor] = {}
HUGE_WAIT: Dict[torch.device, torch.Tensor] = {}  # the same, of the huge body
HUGE_COUNT_EVERY = 50
# by body with a counting form: one profiled launch of an entry in this many takes it
COUNT_EVERY = {HUGE_L2: 1, HUGE: HUGE_COUNT_EVERY}
PROFILED = {(body, k): 0 for body in COUNT_EVERY for k in L2_ENTRIES}  # launches under a profiler
COUNTED = dict(PROFILED)  # of those, the launches of the counting forms
HUGE_RING = {kernel: 0 for kernel in L2_ENTRIES}  # huge launches that took the ring form
_COUNTING_FITS: Dict[tuple, bool] = {}
_RECORDS: Dict[tuple, ctypes.Array] = {}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in L2_ENTRIES:
        HUGE_RING[k] = 0
    for k in PROFILED:
        PROFILED[k] = COUNTED[k] = 0
    for t in (*L2_WAIT.values(), *HUGE_WAIT.values()):
        t.zero_()


def _wait_acc(body: str, kernel: str, device: torch.device) -> int:
    """The address of ``kernel``'s row of the device's tensor of the sums
    that ``body``'s counting form adds into (``L2_WAIT`` or ``HUGE_WAIT``),
    made on first use."""
    sums = L2_WAIT if body == HUGE_L2 else HUGE_WAIT
    t = sums.get(device)
    if t is None:
        t = sums[device] = torch.zeros((len(L2_ENTRIES), 2), dtype=torch.int64, device=device)
    return t.data_ptr() + L2_ENTRIES.index(kernel) * t.stride(0) * t.element_size()


def _wait_cycles(sums: Dict[torch.device, torch.Tensor]) -> Dict[str, Tuple[int, int]]:
    out = {k: (0, 0) for k in L2_ENTRIES}
    for t in sums.values():
        for k, (wait, cycles) in zip(L2_ENTRIES, t.tolist()):
            out[k] = (out[k][0] + wait, out[k][1] + cycles)
    return out


def l2_wait_cycles() -> Dict[str, Tuple[int, int]]:
    """(barrier wait, block cycles) of the L2 body's counted launches by
    entry, summed over the devices (SM cycles; a read on the host)."""
    return _wait_cycles(L2_WAIT)


def huge_wait_cycles() -> Dict[str, Tuple[int, int]]:
    """(barrier wait, block cycles) of the shared-memory huge body's counted
    launches by entry, summed over the devices (SM cycles; a read on the host)."""
    return _wait_cycles(HUGE_WAIT)


def _counting_fits(launch: BodyLaunch, itemsize: int, device) -> bool:
    """Whether the counting form of ``launch``'s body holds as many blocks an
    SM as its own entries, by which the plan placed the body, at the
    launch's threads and shared memory (``layout.block_occupancy``)."""
    key = (launch.body, itemsize, launch.threads, launch.smem_forward, launch.smem_backward,
           launch.own, device)
    if key not in _COUNTING_FITS:
        _COUNTING_FITS[key] = all(
            block_occupancy(itemsize, launch.body, launch.threads, device, smem, launch.own,
                            counting=True)
            >= block_occupancy(itemsize, launch.body, launch.threads, device, smem, launch.own)
            for smem in {launch.smem_forward, launch.smem_backward})
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


def _records(plan: LaunchPlan, run: bool, scratch) -> ctypes.Array:
    """The library's records of ``plan``'s launches of the half-sweeps
    (``run``: of the run-only entry), the L2 body's with the scratch
    ``scratch``: made once per plan, entry and scratch and shared by the
    entry's closures, which set only the counting accumulators."""
    key = (plan, run, None if scratch is None else scratch.data_ptr())
    records = _RECORDS.get(key)
    if records is None:
        if len(_RECORDS) >= 256:
            _RECORDS.clear()
        launches = plan.runs if run else plan.sweeps
        base = 0 if scratch is None else scratch.data_ptr()
        parts, counters, _ = plan.scratch_bytes
        records = _RECORDS[key] = (_build.Launch * len(launches))(*(
            _build.Launch(r.table.data_ptr(), BODIES.index(r.body), r.nr_buckets, r.blocks,
                          r.threads, r.smem_forward, r.smem_backward, r.own,
                          *((base, base + parts, base + counters) if r.body == HUGE_L2
                            else (None, None, None)))
            for r in launches))
    return records


def _launcher(kernel: str, plan: LaunchPlan, arcs, lo, hi, din_lo, din_hi, alpha, omega,
              frontier, outs, scratch=None):
    """A closure that queues ``kernel`` on the current stream, the launches
    of the plan's records in order (the run entry's by its own route), in
    one call of the library, and raises on a launch error, naming the body.
    It holds its tensors alive and does not count in ``LAUNCHES``;
    ``launch.counts`` names the key of ``LAUNCHES`` of every launch a call
    makes. ``scratch``: the L2 body's (:func:`layout.huge_scratch`): the key
    rows, which the forward reads, and the partials and counters of the
    column barriers, which every entry needs where the plan splits a column.
    Under a profiler a launch takes its body's counting form as COUNT_EVERY
    says, where it fits (``L2_WAIT``, ``HUGE_WAIT``)."""
    suffix = _suffix(lo.dtype)
    launches = plan.runs if kernel == RUN else plan.sweeps
    if scratch is None and any(r.body == HUGE_L2 for r in launches):
        raise ValueError(f"{kernel}: the L2 body's launch needs its scratch "
                         f"(layout.huge_scratch)")
    if isinstance(omega, torch.Tensor) and omega.dim() > 0:
        omega_arr, omega_val = omega, 0.0
    else:
        omega_arr, omega_val = None, float(omega)

    def ptr(t):  # the run entry has no deltas, no incoming frontier, no cost outputs
        return None if t is None else t.data_ptr()

    buffers = _build.Buffers(
        arcs.data_ptr(), lo.data_ptr(), hi.data_ptr(), ptr(din_lo), ptr(din_hi), ptr(alpha),
        ptr(omega_arr), omega_val, ptr(frontier), *(ptr(o) for o in outs))
    records = _records(plan, kernel == RUN, scratch)
    fn = getattr(_build.load(), f"{kernel}_{suffix}")
    stream = torch.cuda.current_stream(lo.device).cuda_stream
    failed = ctypes.c_int(-1)
    # the records of a body with a counting form, with the address of the
    # entry's accumulators where the form fits (else None), set anew each
    # call: the records are shared. Asked here and not in a traced launch:
    # the card's first answer loads the counting entries.
    counting = [(i, r.body, _wait_acc(r.body, kernel, lo.device)
                 if _counting_fits(r, lo.element_size(), lo.device) else None)
                for i, r in enumerate(launches) if r.body in COUNT_EVERY]

    def launch() -> None:
        profiled = bool(counting) and torch._C._autograd._profiler_enabled()
        for i, body, acc in counting:
            due = False
            if profiled and acc is not None:
                due = PROFILED[body, kernel] % COUNT_EVERY[body] == 0
                PROFILED[body, kernel] += 1
                COUNTED[body, kernel] += due
            records[i].acc = acc if due else None
        rc = fn(records, len(launches), ctypes.byref(buffers), stream, ctypes.byref(failed))
        if rc != 0:
            raise RuntimeError(f"{kernel}{launches[failed.value].body}_{suffix} launch failed "
                               f"(code {rc}) over buckets {plan.shapes}")

    launch.keep = (plan, arcs, lo, hi, din_lo, din_hi, alpha, omega_arr, frontier, outs, scratch)
    launch.counts = tuple(kernel + r.body for r in launches)
    launch.ring = kernel if any(r.body == HUGE and r.own[1] for r in launches) else None
    return launch


def _launch_counted(launch) -> None:
    launch()
    for name in launch.counts:
        LAUNCHES[name] += 1
    if launch.ring:
        HUGE_RING[launch.ring] += 1


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
    scratch = geom.huge_scratch if plan is geom.plan else huge_scratch(plan, lo.device)
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
    scratch = geom.huge_scratch if plan is geom.plan else huge_scratch(plan, lo.device)
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
                       huge_scratch(plan, lo.device))
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
                              huge_scratch(plan, lo.device)))
    return _node_view(P, stored)
