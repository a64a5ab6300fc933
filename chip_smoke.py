#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (bdd_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py
(``python3 chip_smoke.py --huge-split [part ...]`` times variants of the
huge body, the route on a whole huge table, the cluster body's cluster
sizes and the L2 body's barriers instead: see ``huge_split``;
``python3 chip_smoke.py --huge-ring`` the huge body's ring form on the
gap_d60900 layout: see ``huge_ring``)

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. card: CUDA present, card name and power limit; build both libraries of
     the port from the checkout's sources, the two compilers side by side
     (nvcc: the sweep kernels; g++: the host library with the CPU solver);
  2. kernels vs twins on the card, on state after a few iterations of the
     gm50k graph-matching instance (float32 packed, float64 unpacked) and of
     a packed grid MRF: one forward and one backward half-sweep per bucket
     through a one-bucket table, and as ONE fused launch over all buckets of
     the host, through the wrappers the iteration calls, against the twins
     bucket by bucket. Built with -fmad=false the kernels must equal the
     torch twins exactly (same ±inf pattern, max |diff| = 0). Each launch is
     timed warm (as the iteration finds it) and cold (a buffer larger than
     the L2 cache written in between), beside its bound: the bytes the launch
     must move for the columns that hold a BDD (padding columns left out)
     over the card's memory rate; gm50k float32 also at forced
     prefetch depths and left unpacked;
  3. main path at size: ``bdd_tpu_torch.api.BddSolver(device="cuda")`` solves
     gm50k dual-only for 500 iterations in float32 (twice, bit-identical
     bounds) and float64, held to the port's native C++ OpenMP solver on the
     same instance (rel 1e-3 in float32, 1e-7 in float64); both kernels must
     be launched exactly once per iteration in either precision;
  4. main path with rounding: default config on the 12x12x4 grid MRF; the
     solution must be feasible with objective >= lower bound;
  5. times on the card: iterations/s through the kernels, through the twins,
     and of the native C++ baseline; a torch.profiler trace of one iteration
     block per precision: device busy share, and the number of host syncs
     between the block's first and last launch, which must be 0;
  6. wide and huge buckets: 2,000 knapsack rows of 40 variables over 20,000 variables
     (coefficients 1..20, right-hand side half the row sum), whose BDDs are
     wider than 32 slots and run through the warp-a-column body of the
     kernels (a launch of its own per half-sweep): kernel vs twin on every
     bucket and fused, float32 and float64, times beside the byte bound (and
     the huge body forced on the same layout), and a 100-iteration dual solve
     per precision held to the native C++ solver, with the launches counted
     and the twins' call counter unmoved. Then 132 rows of 48 variables with
     coefficients 1..1,000 (knapsack48: P = 16,384, four-byte arcs, the
     block-a-column huge body with its rows in shared memory, a launch of its
     own; 132 columns, not padded): kernel == twin, times beside the byte
     bound; the P = 8,192 rows (knapsack32) on the body the route gives
     them, beside the wide body ("[huge] crossover": forward, backward, run,
     both precisions, every launch held to the plain versions; P = 256 to
     4,096 and more columns: --huge-split columns), with 20 counted
     iterations; the huge body's counting entries on knapsack48 and on the
     benchmark's gap_d60900.dual layout (60 rows of 1,024 slots over 900
     hops, the ring form), bit for bit against the uncounted launches and
     timed beside them (``--huge-ring``: that layout's ring form beside the
     grouped body and at each ring depth); knapsack48 and knapsack32 in one layout (one huge table of
     388 columns); 132 rows of 48
     variables with coefficients up to 2,000 (P = 32,768, past a block's
     shared memory) on the cluster body (a cluster of blocks a column, the
     row split over their shared memory), beside the L2 body forced on the
     same layout, with 20 counted float64 iterations held to the native
     solver's bound after as many; 8 such rows with coefficients up to 4,000
     (P = 65,536, eight-byte slot codes) on the cluster body, with 20
     counted float64 iterations held the same way; one row with
     coefficients up to 16,000 (P = 262,144, past a cluster of 16 in
     float64) on the L2 body, its column spread over G blocks, with the
     form of one block a column forced beside it and 20 counted float64
     iterations; the benchmark's mknap.t50.dual layout (5 rows of 32,768
     slots) on the L2 body and mknap.t25.dual's (5 of 16,384, which a block
     holds) on the cluster body by the route (the huge and the L2 body
     forced beside it), with the L2 body's counting entries; and a
     100-iteration float64 solve of knapsack48 against the native solver,
     every half-sweep one launch of the huge body;
  7. Python pipeline (BddPreprocessor -> flatten_uniform) on grid12: float64
     bound against the native pipeline's (rel 1e-7), default float32 with the
     host rounding, and one solve each with BDD splitting, wedelin and best;
  8. batched solve: ``solve_batch`` over 64 and 256 independent-set
     instances, 100 iterations, rounding off and on; per-instance bounds
     against the instances solved alone, every solution checked against its
     own ILP, one launch per kernel and iteration;
  9. server: ``bdd_tpu_torch.serve.serve`` in process over JSONL lines (two
     grid12 requests, a gm50k file whose bound must equal phase 3's to the
     last bit, a batch request, a line that is no JSON, a missing file,
     shutdown), the launches of every request counted, and the same server
     as a fresh process for its cold and warm request times.
 10. outer loops: "lbfgs parallel mma" (float64, rounding on, twice) and
     "subgradient" through ``BddSolver.solve`` on grid12, and L-BFGS on gm50k
     (float32, rounding off, a fixed number of outer iterations, twice): the
     L-BFGS bound against plain MMA's after as many iterations (no lower than
     it less 1e-3 relative), reruns bit-identical, launches per outer
     iteration by key, ms per outer iteration beside ms per MMA iteration on
     the same layout, and the hop loops that are still torch ops
     (``bdds_solution``, ``bucket_forward_run``, ``min_marginals_all``) timed
     on gm50k.
 11. tightening: MIS-200 (``independent_set(200, edge_prob=0.15)``), float64,
     ``"tighten": {"cliques": true}``, on the card and on the CPU: BDDs before
     and after, groups melded, the bound before and after (it must rise; the
     warm start must keep the converged bound), card and CPU bounds within rel
     1e-9, wall time by step, launches, and the kernels against the twins on
     the melded layout;
 12. smooth solvers: "smooth mma" on grid12 in float32 and float64 (the float64
     bound against the port's CPU run, rel 1e-9), the smooth bound at a fixed
     temperature (below the hard bound after every iteration; near-monotone
     from a perturbed point of a 3x3 assignment), ms per smooth iteration
     beside ms per MMA iteration on grid12 and gm50k (phase 10's Python
     build), and the kernel launches a hop of the smooth sweeps (torch ops);
     no sweep kernel and no plain version runs, the hard bound comes from
     the run-only entry.
 13. hybrid CPU + GPU ("hybrid mma", ``solver/hybrid.py``): the JAX package's
     hybrid instance (set cover 500 x 2,000 plus one row over all 2,000 sets,
     ``benchmarks/hybrid_solver.py:39-45``), whose 2,000-level BDD goes to the
     native solver's worker thread at the automatic threshold, in float32 and
     float64 for 200 iterations: the bound against the native solver over the
     whole collection (rel 1e-3 / 1e-7), float64 against the same solve on the
     CPU (rel 1e-9), ``to_native_full`` continuing the trajectory (rel 1e-7),
     it/s beside the native solver's and the card's alone with the deep BDD
     unsplit, the host half-sweep alone and inside the hybrid, host syncs per
     iteration from a profiler trace (exactly 2: one per consensus), one
     launch of each half-sweep per iteration and no plain version; gm50k
     float32 on phase 10's Python build with every 50th BDD on the host, the
     same checks, ms per iteration beside plain MMA's; "hybrid mma" through
     ``BddSolver.solve`` on grid12 with rounding (the BDDs of depth 16 on the
     host); the worker thread gone after ``close()``; then the extras on the
     card: phase 3's gm50k float32 state moved to a float64 native solver
     (``transfer_costs_to_native``), and a checkpoint (``save_state`` /
     ``load_state``) whose next 10 iterations equal the uninterrupted run's
     bit for bit.
 14. the learned solver (DOGE, ``learn/``, ``solver/learned.py``): the JAX
     package's trained ``benchmarks/doge_gm120.ckpt`` read by the port's own
     reader, on gm120 seed 100 (``graph_matching(120, 120, seed=100,
     candidates=6, nr_quadratic=2000)``, the held-out instance of
     ``benchmarks/train_doge_scale.py``; float32, the trainer's Python
     pipeline): (a) the GNN's per-layer alpha and omega through one fused
     forward and one fused backward launch and the run entry, bit-equal to
     the twins and timed beside the byte bound (alpha and omega counted as
     arrays); (b) the checkpoint's rollout, 5 rounds x 20 learned
     iterations with history and smooth features: the per-round bounds, one
     host sync per rollout (sync debug mode) and none between its first and
     last launch (profiler), ms per round by span (features, GNN,
     iterations, bound) and the device busy share, one launch of each
     half-sweep per learned iteration, plain MMA on the same layout for 100
     iterations beside it (not gated), and the first round through the
     twins, bit-equal; (c) training on gm120 seed 0 (phase 10's Python
     build), depth cut to 2 rounds (one pre-round, one with gradients): the
     kernels with the same alpha and omega held to the twins on that layout,
     the parameter gradients of the autograd Functions (kernels forward, the
     twins recomputed backward) against plain autograd through the twins
     (rel 1e-6 of the largest entry; losses bit-equal), and a training
     step (finite loss, parameters moved, one launch of each half-sweep per
     learned iteration).
 15. the sharded solve (``solver/uniform_sharded.py``): two rank processes
     of this script (``--sharded-rank``) on the one card, joined by gloo
     (NCCL refuses two ranks a card; gloo stages the card's tensors through
     the host), each holding one shard of gm50k (phase 3's LP through the
     native host library, partition "auto"): float32 and float64 solves of
     500 iterations held to phase 3's bound and to the native solver (rel
     1e-3 / 1e-7), launches counted per rank, no plain sweep; the kernels
     against the twins on rank 0's shard layout; one all_reduce of the
     shared rows and of all rows timed; host syncs and device busy share of
     a profiled block; "lbfgs sharded mma" beside "sharded mma" through
     BddSolver on grid12; one ShardedDogeTrainer step (the checkpoint's
     configuration without history features, 2 rounds); every rank's bounds
     the same, and no rank imported JAX. Then rank 0 alone in a process
     group over NCCL on grid12, every row of the sums through the backend:
     the float32 bound against the one-device solver's on the same
     collection. The dense part: in the same two ranks, the dense sharded
     solve (``solver/sharding.py``'s ``ShardedSolver``) over the native
     host's gm50k collection, float32 and float64, 100 iterations, one
     all_reduce of the [V + 1, 2] delta pair per half-sweep: every rank's
     bound equal, held to a one-device DenseSolver on the same collection
     (run by this process while the ranks build their layouts; rel 1e-5 /
     1e-12), ms an iteration and per all_reduce.
 16. the dense backend ("dense mma", ``solver/dense.py``, torch ops in a hop
     loop; no sweep kernel, so no row of its own): (a) DenseSolver on phase
     10's Python build of gm50k, 200 iterations, float32 twice (bit-identical)
     and float64, held to the uniform solver on the same build after as many
     iterations (rel 1e-3 / 1e-9), it/s beside the uniform path's, kernel
     launches an iteration, device busy share and host syncs (0) from a
     profiled block; (b) grid12 float64 on the card against the CPU (rel
     1e-12); (c) "dense mma" through BddSolver on grid12 with the default
     rounding (dual depth cut to 100 iterations): feasible, objective >=
     bound; with "tighten" the bound is kept; (d) L-BFGS and subgradient over
     DenseSolver on grid12 float64, 100 outer iterations, beside plain dense
     MMA; (e) the log-depth prefix sweeps (``solver/prefix.py``) on phase 2's
     unpacked gm50k layouts against the run-only kernel's costs-to-terminal
     and bound, the plain forward run and ``min_marginals_all`` (float64 abs
     1e-9, float32 rel 1e-5), timed beside them; (f) a checkpoint saved and
     loaded on the card, the next 10 iterations bit for bit. Every dense solve
     is checked to move neither the sweep kernels' launch counts nor the
     plain versions' call counts.
Every layout that phases 2 and 6-11 hold the half-sweeps on also holds the
run-only entry of the backward kernel (``uniform_backward_run``: the
costs-to-terminal of given costs) to the plain run, bit-equal, timed warm and
cold beside its byte bound; the knapsack layout also times the wide body at
forced ring depths and warps a block. No solve, round or outer iteration on
the card may call a plain sweep or the plain backward run (counters checked).
Phases 7-9 hold the kernels to the twins as phase 2 does (bit-equal, timed
beside the byte bound) on the layouts their own paths built (flatten_uniform's
grid12, plain and split; the batches of 64 and 256; the server's batch) from
the state their solves left, and check that no twin sweep ran in any solve;
phase 13 does the same on both hybrid device layouts (a BDD subset whose
alpha comes from the whole collection's counts).

Imports nothing of JAX, flax, optax, msgpack or bdd_tpu (checked at the
end): the port carries its own host library, ILP model, frontends,
generators and checkpoint reader.
Prints the card line, one JSON line of per-kernel results (a row per kernel,
body and path: gm50k, knapsack, knapsack48 (huge), knapsack32 (huge, routed),
knapsack48 L2 (the L2 body), python grid12, batch64,
batch256, the server's batch, the L-BFGS layouts, tighten mis200, hybrid
deep, hybrid gm50k, gm120 learned (the rollout), gm120 train, sharded gm50k
(rank 0's shard)), and as the
last line {"ok": true, "device": {...}}.
"""
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

GM_ITERS = 500
TOL = {"float32": 0.0, "float64": 0.0}  # bit-equal: -fmad=false, same op order
LB_REL = {"float": 1e-3, "double": 1e-7}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
L2_FLUSH_BYTES = 256 << 20  # several times the 50 MB L2
KERNELS = ("uniform_forward", "uniform_backward")
RUN = "uniform_backward_run"  # the backward kernel's entry without the cost update
WIDE = "_wide"  # suffix of the wide-bucket body's entries in errs, times and the kernels line
HUGE = "_huge"  # the same for the huge body (a block a column, rows in shared memory)
HUGE_CLUSTER = "_huge_cluster"  # its cluster form (rows past a block's, within a cluster's)
HUGE_L2 = "_huge_l2"  # the same for its L2 form (rows past a cluster's shared memory)
BODIES = ("", WIDE, HUGE, HUGE_CLUSTER, HUGE_L2)
KNAPSACK_ITERS = 100  # cut from 200 (PR 8): the native solver's share of the phase
BATCH_ITERS = 100
GRID_OUTER_ITERS = 200
GM_OUTER_ITERS = 100
SYNC_EVENTS = ("aten::_local_scalar_dense", "aten::item", "cudaStreamSynchronize",
               "cudaDeviceSynchronize", "cudaEventSynchronize")


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def launch_counts(narrow: int = 0, wide: int = 0, huge: int = 0, huge_cluster: int = 0,
                  huge_l2: int = 0) -> dict:
    """The half-sweep keys of ``sweep_kernels.LAUNCHES`` after ``narrow``,
    ``wide``, ``huge``, ``huge_cluster`` and ``huge_l2`` launches of either
    kernel's narrow, wide, huge, cluster and L2 body."""
    return {k + body: n for k in KERNELS
            for body, n in (("", narrow), (WIDE, wide), (HUGE, huge),
                            (HUGE_CLUSTER, huge_cluster), (HUGE_L2, huge_l2))}


def sweeps_of(counts: dict) -> dict:
    """The half-sweep keys of a copy of ``sweep_kernels.LAUNCHES`` (the run-only
    entry launches at every state refresh: init, delta folding, cost updates)."""
    return {k: n for k, n in counts.items() if not k.startswith(RUN)}


def plain_calls() -> dict:
    """Calls of the plain versions so far: the twin half-sweeps, and the plain
    backward run on a CUDA tensor. A solve on the card must move neither."""
    from bdd_tpu_torch.solver import uniform as uf

    return {**uf.TWIN_SWEEP_CALLS, **uf.PLAIN_RUN_CALLS}


def gm50k_lp(seed: int = 0) -> str:
    """The gm50k instance (gm120 of ``benchmarks/train_doge_scale.py``) of a seed."""
    from bdd_tpu_torch.frontends.graph_matching import construct_graph_matching_ilp
    from bdd_tpu_torch.utils.problems import graph_matching

    inst = graph_matching(120, 120, seed=seed, candidates=6, nr_quadratic=2000)
    return construct_graph_matching_ilp(inst)[0].write_lp()


def cuda_ms(fn, reps: int, flush=None) -> float:
    """Device time of one fn() (CUDA events), warmed: reps launches back to
    back in up to four batches, the least batch mean (a batch the host
    enqueued slower than the card ran would read the host's time).
    ``flush``: a buffer larger than L2, rewritten before every launch so the
    launch finds the cache cold; only the launch itself is timed (mean)."""
    import torch

    fn()
    torch.cuda.synchronize()
    if flush is None:
        batches = []
        per_batch = max(1, reps // 4)
        for _ in range(max(1, reps // per_batch)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_batch):
                fn()
            end.record()
            torch.cuda.synchronize()
            batches.append(start.elapsed_time(end) / per_batch)
        return min(batches)
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def compare(out, ref, tol: float) -> float:
    """Max |diff| over finite entries; fails unless the ±inf patterns match."""
    import torch

    err = 0.0
    for x, y in zip(out, ref):
        if x.shape != y.shape:
            fail(f"kernel output {tuple(x.shape)} vs twin {tuple(y.shape)}")
        fx, fy = torch.isfinite(x), torch.isfinite(y)
        if not torch.equal(fx, fy) or not torch.equal(x[~fx], y[~fy]):
            fail("kernel and twin disagree on the ±inf pattern")
        if fx.any():
            err = max(err, float((x[fx] - y[fx]).abs().max()))
    if err > tol:
        fail(f"kernel vs twin max |diff| {err} > {tol}")
    return err


def bdd_shapes(buckets):
    """(P, H, columns that hold a BDD) per bucket: the work a launch must do.
    A padding column (no valid layer; the layouts pad B to TPU lanes) holds
    nothing the solve needs, so the byte bounds leave it out."""
    return [(g.P, g.H, int(g.layer_valid.any(0).sum())) for g in buckets]


def launch_bytes(shapes, itemsize: int, forward: bool, omega_array: bool = False) -> int:
    """Bytes one launch must move: every input read once, every output
    written once. Per (hop, column) of ``shapes`` (:func:`bdd_shapes`): the
    geometry record, lo hi din_lo din_hi alpha (and omega, when it is an
    array: the learned path) and P frontier values in, 3 + P values out. The
    forward kernel never reads cft of hop 0."""
    from bdd_tpu_torch.solver.layout import record_bytes

    total = 0
    values_in = 6 if omega_array else 5
    for P, H, B in shapes:
        frontier_rows = H - 1 if forward else H
        total += H * B * (record_bytes(P) + values_in * itemsize + (3 + P) * itemsize)
        total += frontier_rows * P * B * itemsize
    return total


def run_bytes(shapes, itemsize: int) -> int:
    """Bytes one launch of the run-only entry must move: per (hop, column) of
    ``shapes`` (:func:`bdd_shapes`) the geometry record, lo and hi in, P
    frontier values out."""
    from bdd_tpu_torch.solver.layout import record_bytes

    return sum(H * B * (record_bytes(P) + (2 + P) * itemsize) for P, H, B in shapes)


def share(bound_ms: float, ms: float) -> str:
    if ms < bound_ms:
        return "under the device-memory bound: L2 served it"
    return f"{100 * bound_ms / ms:.1f}% of bound"


def check_index_on_card(label, geom) -> None:
    """The exchange index as it lies on the card, before anything gathers
    through it: every id within [0, V], and ids and valid mask equal to what
    the buckets' own tensors say (the variable of each slot and the layer
    flag of its arc record: separate copies to the card), V at invalid
    slots. Comparisons only, so a bad index is reported here by position and
    not as a device-side assert of the first gather."""
    import torch

    ex = geom.exchange
    if ex.ids.numel() == 0:
        return
    var = torch.cat([g.layer_var.reshape(-1) for g in geom.buckets])
    valid = torch.cat([g.layer_valid.reshape(-1) for g in geom.buckets])
    want = torch.where(valid, var, torch.full_like(var, geom.V))
    bad = (ex.ids != want) | (ex.ids < 0) | (ex.ids > geom.V) | (ex.valid != valid)
    nr_bad = int(bad.sum())
    if nr_bad:
        at = torch.nonzero(bad).reshape(-1)[:8]
        fail(f"{label}: the exchange index on the card is off at {nr_bad} of {bad.numel()} "
             f"slots (V = {geom.V}); first at {at.tolist()}: ids {ex.ids[at].tolist()}, "
             f"expected {want[at].tolist()}, valid {ex.valid[at].tolist()} / {valid[at].tolist()}")


def kernel_vs_twin(label, host, objective, card, errs, times, flush, variants=(), suffix="",
                   state=None, reps=200, run_suffix=None):
    """Phase 2 for one host: every bucket alone, then all buckets fused, then
    the run-only entry; ``variants``: keyword sets of :func:`variant_plan`
    (forced ring depths, warps a block, bodies, threads a block of a huge
    form) to time the fused launches (and, where a huge form runs, the run
    entry) at as well;
    ``suffix``: the body every bucket of the host runs (WIDE, HUGE,
    HUGE_CLUSTER, HUGE_L2), ``run_suffix`` the body of its run-only entry
    where the run's route differs (the cluster body's buckets run on the L2
    body);
    ``state``: the state to sweep from (a solver's, after its solve) instead
    of five iterations from ``objective``; ``reps``: the warm launches a
    fused launch is timed over (a tenth of them cold, half per bucket),
    fewer where one launch takes milliseconds."""
    import torch
    from bdd_tpu_torch.solver import layout
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf

    geom = host.geom
    dt = str(geom.dtype).replace("torch.", "")
    itemsize = torch.empty((), dtype=geom.dtype).element_size()
    check_index_on_card(label, geom)
    if state is None:
        state = uf.iterations(geom, uf.init_uniform_state(host, objective), 5)
    st = state
    lo, hi, mm, cft = st.flat
    dl_flat, dh_flat = uf.exchange_delta_flat(geom, mm)
    dl, dh = geom.per_bucket(dl_flat), geom.per_bucket(dh_flat)
    entry = times.setdefault((label, dt), {})
    refs_f, refs_b = [], []
    for k, g in enumerate(geom.buckets):
        args = (g, st.lo[k], st.hi[k], st.cft[k], 0.5, dl[k], dh[k])
        before = dict(sk.LAUNCHES)
        out = sk.bucket_forward_iteration_cuda(*args)
        ref = uf.bucket_forward_iteration(*args)
        torch.cuda.synchronize()
        errs["uniform_forward" + suffix] = max(errs["uniform_forward" + suffix],
                                               compare(out, ref, TOL[dt]))
        bargs = (g, ref[0], ref[1], ref[3], 0.5, dl[k], dh[k])
        out_b = sk.bucket_backward_iteration_cuda(*bargs)
        ref_b = uf.bucket_backward_iteration(*bargs)
        torch.cuda.synchronize()
        errs["uniform_backward" + suffix] = max(errs["uniform_backward" + suffix],
                                                compare(out_b, ref_b, TOL[dt]))
        refs_f.append(ref)
        refs_b.append(ref_b)
        # device time of the kernel alone (pre-validated launches) vs the twin
        launch_f, _ = sk.prepare_launch("uniform_forward", *args)
        launch_b, _ = sk.prepare_launch("uniform_backward", *bargs)
        shape = bdd_shapes([g])
        t = {
            "uniform_forward": (cuda_ms(launch_f, reps // 2),
                                cuda_ms(lambda: uf.bucket_forward_iteration(*args), 2),
                                launch_bytes(shape, itemsize, True)),
            "uniform_backward": (cuda_ms(launch_b, reps // 2),
                                 cuda_ms(lambda: uf.bucket_backward_iteration(*bargs), 2),
                                 launch_bytes(shape, itemsize, False)),
        }
        for name, (ms, plain, nbytes) in t.items():
            e = entry.setdefault(name, {"bucket_ms": 0.0, "plain_ms": 0.0})
            e["bucket_ms"] += ms
            e["plain_ms"] += plain
        fb, bb = t["uniform_forward"][2], t["uniform_backward"][2]
        print(
            f"[kernel] {label} {dt} bucket {k} (P={g.P}, H={g.H}, B={g.B}): match; "
            f"fwd {t['uniform_forward'][0]:.4f} ms (bound {1e3 * fb / HBM_BYTES_PER_S:.4f} ms, "
            f"{fb} B) vs twin {t['uniform_forward'][1]:.4f} ms, "
            f"bwd {t['uniform_backward'][0]:.4f} ms (bound {1e3 * bb / HBM_BYTES_PER_S:.4f} ms, "
            f"{bb} B) vs twin {t['uniform_backward'][1]:.4f} ms; "
            f"launches { {k: n - before[k] for k, n in sk.LAUNCHES.items() if n != before[k]} } "
            f"{card}",
            flush=True,
        )
    # ---- one fused launch over all buckets against the twins bucket by bucket
    def cat(outs):  # as the fused wrappers lay them: the frontier in storage order
        new_lo, new_hi, new_mm, frontier = zip(*outs)
        return (layout.flatten(new_lo), layout.flatten(new_hi), layout.flatten(new_mm),
                geom.flatten_nodes(frontier))

    ref_f, ref_b = cat(refs_f), cat(refs_b)
    args_f = (geom, lo, hi, cft, 0.5, dl_flat, dh_flat)
    args_b = (geom, ref_f[0], ref_f[1], ref_f[3], 0.5, dl_flat, dh_flat)
    for name, wrapper, args, ref in (
        ("uniform_forward", sk.forward_iteration_cuda, args_f, ref_f),
        ("uniform_backward", sk.backward_iteration_cuda, args_b, ref_b),
    ):
        before = dict(sk.LAUNCHES)
        out = wrapper(*args)
        torch.cuda.synchronize()
        errs[name + suffix] = max(errs[name + suffix], compare(out, ref, TOL[dt]))
        rose = sweeps_of({k: n - before[k] for k, n in sk.LAUNCHES.items()})
        want = {**launch_counts(), **{name + r.body: 1 for r in geom.plan.sweeps}}
        if rose != want:
            fail(f"{label} {dt}: one fused {name} call counted launches {rose}, not {want}")
    # the timing loops launch directly: checked once, no allocation, no count
    launch_f, _ = sk.prepare_fused_launch("uniform_forward", *args_f)
    launch_b, _ = sk.prepare_fused_launch("uniform_backward", *args_b)
    wrapper_ms = cuda_ms(
        lambda: sk.forward_iteration_cuda(geom, lo, hi, cft, 0.5, dl_flat, dh_flat), 50)
    plan = geom.plan
    for name, launch, fwd in (("uniform_forward", launch_f, True),
                              ("uniform_backward", launch_b, False)):
        nbytes = launch_bytes(bdd_shapes(geom.buckets), itemsize, fwd)
        e = entry[name]
        e.update(ms=cuda_ms(launch, reps), cold_ms=cuda_ms(launch, reps // 10, flush),
                 bytes=nbytes,
                 bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)
        print(
            f"[fused] {label} {dt} {name}: one launch per body, {plan_text(plan)}: match; "
            f"warm {e['ms']:.4f} ms ({share(e['bound_ms'], e['ms'])}), "
            f"cold {e['cold_ms']:.4f} ms ({share(e['bound_ms'], e['cold_ms'])}), "
            f"bound {e['bound_ms']:.4f} ms = {nbytes} B (columns with a BDD) at 3.35 TB/s; "
            f"per-bucket launches "
            f"summed {e['bucket_ms']:.4f} ms; twins summed {e['plain_ms']:.4f} ms {card}",
            flush=True,
        )
    print(f"[fused] {label} {dt} forward wrapper call (checks, 4 allocations, 1 launch): "
          f"{wrapper_ms:.4f} ms per call {card}", flush=True)
    run_ref = None
    for forced in variants:
        deep = variant_plan(plan.shapes, geom.dtype, geom.device, **forced)
        row = []
        for name, args, fwd in (("uniform_forward", args_f, True),
                                ("uniform_backward", args_b, False)):
            launch, out = sk.prepare_fused_launch(name, *args, plan=deep)
            launch()
            torch.cuda.synchronize()
            compare(out, ref_f if fwd else ref_b, TOL[dt])
            warm, cold, bound = cuda_ms(launch, reps), cuda_ms(launch, reps // 10, flush), entry[name][
                "bound_ms"]
            row.append(f"{name} warm {warm:.4f} ms ({share(bound, warm)}), cold {cold:.4f} ms "
                       f"({share(bound, cold)})")
        if any(r.body in (HUGE, HUGE_CLUSTER, HUGE_L2) for r in deep.runs):  # the run entry too
            if run_ref is None:
                run_ref = geom.flatten_nodes([uf.bucket_backward_run(g, a, b) for g, a, b in zip(
                    geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))])
            launch, out = sk.prepare_run_launch(geom, lo, hi, deep)
            launch()
            torch.cuda.synchronize()
            compare([out], [run_ref], TOL[dt])
            warm, cold = cuda_ms(launch, reps), cuda_ms(launch, reps // 10, flush)
            bound = 1e3 * run_bytes(bdd_shapes(geom.buckets), itemsize) / HBM_BYTES_PER_S
            row.append(f"{RUN} warm {warm:.4f} ms ({share(bound, warm)}), cold {cold:.4f} ms "
                       f"({share(bound, cold)})")
        print(f"[depth] {label} {dt} {forced}: {plan_text(deep)}: match; "
              f"{'; '.join(row)} {card}", flush=True)
    run_vs_plain(label, geom, lo, hi, card, errs, entry, flush,
                 suffix if run_suffix is None else run_suffix, reps)


def plan_text(plan) -> str:
    """Each launch of ``plan``'s half-sweeps and of its run: the body, its
    buckets, blocks and threads, own integers, the last column of its table
    (stages, backward rows or key-row offsets) and its shared memory."""
    def text(r):
        return (f"{r.body[1:] or 'narrow'} {r.nr_buckets} bucket(s), {r.blocks} blocks of "
                f"{r.threads} threads, own {r.own}, last column "
                f"{[int(x) for x in r.table[:, 7].tolist()]}, {r.smem_forward} / "
                f"{r.smem_backward} B shared")

    return "; ".join(map(text, plan.sweeps)) + "; the run: " + "; ".join(map(text, plan.runs))


def variant_plan(shapes, dtype, device, body=None, threads=None, **tunables):
    """The plan of a timing variant: ``layout.build_plan`` over ``shapes``
    with ``tunables`` (stages, warps a block, cluster size, L2 split, ring
    hops), on the route's bodies or, with ``body`` (a name of
    ``layout.BODIES``), on ``body`` for every bucket it takes, all three
    entries ("wide": past NARROW_P up to WIDE_P; "huge": past NARROW_P where
    a block holds the rows, else the body of the width; "huge_cluster": past
    WIDE_P where a cluster of 16 holds them; "huge_l2": past WIDE_P);
    ``threads``: the threads a block of ``body``'s launches, set on a copy
    (a huge launch wider than them takes the grouped body)."""
    import torch
    from bdd_tpu_torch.solver import layout

    itemsize = torch.empty((), dtype=dtype).element_size()
    bodies, runs = layout.route(tuple(shapes), itemsize, str(torch.device(device)))
    if body is not None:
        takes = {"wide": lambda P: layout.NARROW_P < P <= layout.WIDE_P,
                 "huge": lambda P: P > layout.NARROW_P,
                 "huge_cluster": lambda P: P > layout.WIDE_P and layout.cluster_fits(P, itemsize),
                 "huge_l2": lambda P: P > layout.WIDE_P}[body]
        bodies = runs = [
            (body if body != "huge" or layout.huge_fits(P, itemsize)
             else layout.body_of(P, itemsize, B)) if takes(P) else b
            for (P, _, B), b in zip(shapes, bodies)]
    plan = layout.build_plan(shapes, dtype, device, bodies, runs, **tunables)
    if threads is None:
        return plan

    def one(r):
        if r.body != BODIES[layout.BODIES.index(body)]:
            return r
        hops = r.own[1] if body != "huge" or r.own[0] <= threads else 0
        return dataclasses.replace(r, threads=threads, own=(r.own[0], hops))

    return dataclasses.replace(plan, sweeps=tuple(map(one, plan.sweeps)),
                               runs=tuple(map(one, plan.runs)))


def launch_of(plan, body, run=False):
    """``plan``'s launch of ``body`` (a suffix of BODIES) in its half-sweeps
    (``run``: in its run), None where it has none."""
    return next((r for r in (plan.runs if run else plan.sweeps) if r.body == body), None)


def blocks_of(plan, body, run=False) -> int:
    return getattr(launch_of(plan, body, run), "blocks", 0)


def buckets_of(plan, body, run=False) -> int:
    return getattr(launch_of(plan, body, run), "nr_buckets", 0)


def run_vs_plain(label, geom, lo, hi, card, errs, entry, flush, suffix, reps=200):
    """The run-only entry of the backward kernel on the flat costs (lo, hi)
    against the plain run: every bucket alone and all buckets fused, bit-equal;
    the fused launch timed warm and cold beside its byte bound."""
    import torch
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf

    dt = str(geom.dtype).replace("torch.", "")
    itemsize = torch.empty((), dtype=geom.dtype).element_size()
    per_bucket = list(zip(geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi)))

    def plain():
        return [uf.bucket_backward_run(g, a, b) for g, a, b in per_bucket]

    refs = plain()
    key = RUN + suffix
    for (g, a, b), ref in zip(per_bucket, refs):
        out = sk.bucket_backward_run_cuda(g, a, b)
        torch.cuda.synchronize()
        errs[key] = max(errs[key], compare([out], [ref], TOL[dt]))
    before = dict(sk.LAUNCHES)
    out = sk.backward_run_cuda(geom, lo, hi)
    torch.cuda.synchronize()
    errs[key] = max(errs[key], compare([out], [geom.flatten_nodes(refs)], TOL[dt]))
    rose = {k: n - before[k] for k, n in sk.LAUNCHES.items() if n != before[k]}
    want = {RUN + r.body: 1 for r in geom.plan.runs}
    if rose != want:
        fail(f"{label} {dt}: one fused run call counted launches {rose}, not {want}")
    launch, _ = sk.prepare_run_launch(geom, lo, hi)
    nbytes = run_bytes(bdd_shapes(geom.buckets), itemsize)
    e = entry[RUN] = {
        "ms": cuda_ms(launch, reps), "cold_ms": cuda_ms(launch, reps // 10, flush),
        "plain_ms": cuda_ms(plain, 2), "bytes": nbytes,
        "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
    print(f"[run] {label} {dt} {RUN}: one launch per body over {len(geom.buckets)} bucket(s) "
          f"{[tuple(s) for s in geom.plan.shapes][:8]}: match; warm {e['ms']:.4f} ms "
          f"({share(e['bound_ms'], e['ms'])}), cold {e['cold_ms']:.4f} ms "
          f"({share(e['bound_ms'], e['cold_ms'])}), bound {e['bound_ms']:.4f} ms = {nbytes} B "
          f"(columns with a BDD) at 3.35 TB/s; the plain run on the card {e['plain_ms']:.4f} ms "
          f"{card}", flush=True)


def solve_dual(lp, precision):
    """gm50k through the user entry point: dual only, GM_ITERS iterations."""
    from bdd_tpu_torch.api import BddSolver

    cfg = {
        "precision": precision,
        "variable order": "bfs",  # the order of the native baseline's host
        "perturbation rounding": False,
        "termination criteria": {"maximum iterations": GM_ITERS,
                                 "minimum improvement": 0.0,
                                 "improvement slope": 0.0},
    }
    res = BddSolver(cfg, device="cuda").read_ilp(lp_string=lp).solve(verbose=False)
    if res["status"] != "solved" or not math.isfinite(res["lower_bound"]):
        fail(f"{precision} solve: {res['status']}, lb {res['lower_bound']}")
    return res


def profile_block(label, host, objective, card, n=25):
    """torch.profiler over one block of n iterations: device busy share, and
    the host syncs between the block's first and last kernel launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bdd_tpu_torch.solver import uniform as uf
    from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver

    sol = UniformSolver(host, objective)
    sol.iteration_block(5)  # warm
    mm = sol.state.flat[2]
    exchange_ms = cuda_ms(lambda: uf.exchange_delta_flat(sol.geom, mm), 50)
    bound_ms = cuda_ms(lambda: uf.lower_bound(sol.geom, sol.state), 20)
    print(f"[profile] {label}: one exchange {exchange_ms:.4f} ms (2 per iteration), one "
          f"lower bound {bound_ms:.4f} ms (1 per block), enqueued back to back {card}",
          flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sol.iteration_block(n)
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = list(prof.events())
    launches = [e.time_range.start for e in events if e.name == "cudaLaunchKernel"]
    if not launches:
        fail("the profiler saw no kernel launch in an iteration block")
    first, last = min(launches), max(launches)
    syncs = {}
    for e in events:
        if e.name in SYNC_EVENTS and first <= e.time_range.start <= last:
            syncs[e.name] = syncs.get(e.name, 0) + 1
    device_us = 0.0
    for a in prof.key_averages():
        device_us += getattr(a, "self_device_time_total", None) or getattr(
            a, "self_cuda_time_total", 0.0)
    if device_us <= 0:
        fail("the profiler recorded no device time")
    print(
        f"[profile] {label} block of {n} iterations: host syncs between first and last "
        f"launch {sum(syncs.values())} {syncs}; wall {1e3 * wall_s / n:.4f} ms, enqueue "
        f"{1e3 * enqueue_s / n:.4f} ms, device busy {device_us / 1e3 / n:.4f} ms per "
        f"iteration (busy share {device_us / 1e6 / wall_s:.3f}, under the profiler) {card}",
        flush=True,
    )
    top = sorted(prof.key_averages(), key=lambda a: -(getattr(a, "self_device_time_total", 0)
                                                       or 0))[:6]
    for a in top:
        us = getattr(a, "self_device_time_total", 0) or 0
        print(f"[profile]   {label} {a.key[:60]}: {us / n:.1f} us per iteration, "
              f"{a.count / n:.1f} calls {card}", flush=True)
    return sum(syncs.values())


def knapsack_lp(seed: int = 0, nr_vars: int = 20_000, nr_rows: int = 2_000,
                row_len: int = 40, coef_max: int = 20) -> str:
    """Covering knapsack rows with mixed integer coefficients: each row takes
    ``row_len`` variables with coefficients in 1..``coef_max`` and asks for
    at least half of the row sum; positive costs. The rows are cut from
    random permutations of the variables, so every variable lies in the same
    number of rows and none is left to a one-node BDD. With the defaults a
    row's BDD is some 200 nodes wide, far past the 32 slots of the narrow arc
    record; 48 variables with coefficients up to 1,000 make rows wider than
    8,192 slots (the huge body's), 32 variables rows of 8,192."""
    import numpy as np

    rng = np.random.RandomState(seed)
    if nr_vars % row_len or (nr_rows * row_len) % nr_vars:
        raise ValueError("rows must tile whole permutations of the variables")
    cost = rng.randint(1, 100, size=nr_vars)
    lines = ["Minimize", " + ".join(f"{c} x{i}" for i, c in enumerate(cost)), "Subject To"]
    members = np.concatenate([rng.permutation(nr_vars)
                              for _ in range(nr_rows * row_len // nr_vars)])
    for r, var in enumerate(members.reshape(nr_rows, row_len)):
        coef = rng.randint(1, coef_max + 1, size=row_len)
        lines.append(f"r{r}: " + " + ".join(f"{a} x{v}" for a, v in zip(coef, var))
                     + f" >= {int(coef.sum()) // 2}")
    lines.append("End")
    return "\n".join(lines)


DUAL_ONLY = {"perturbation rounding": False}


def fixed_iterations(n: int) -> dict:
    return {"termination criteria": {"maximum iterations": n, "minimum improvement": 0.0,
                                     "improvement slope": 0.0}}


def checked_solution(ilp, res, what: str):
    """The solution of a result dict as a list, checked against its own ILP:
    feasible, objective as reported and not below the bound."""
    if res.get("status") != "solved" or "solution" not in res:
        fail(f"{what}: no solution in {str(res)[:200]}")
    x = [res["solution"][ilp.get_var_name(i)] for i in range(ilp.nr_variables())]
    if not ilp.feasible(x):
        fail(f"{what}: the rounded solution is infeasible")
    obj, lb = ilp.evaluate(x), res["lower_bound"]
    if abs(obj - res["objective"]) > 1e-6 * max(1.0, abs(obj)) or obj < lb - 1e-5 * abs(lb) - 1e-6:
        fail(f"{what}: objective {obj} vs reported {res['objective']}, lb {lb}")
    return x


def phase_wide(card, errs, times, flush):
    """Phase 6: buckets wider than 32 slots through the kernels."""
    import torch
    from bdd_tpu_torch.api import BddSolver
    from bdd_tpu_torch.native import NativeHost
    from bdd_tpu_torch.solver import layout
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf

    t0 = time.perf_counter()
    lp = knapsack_lp()
    nh = NativeHost(lp, "input")
    build_s = time.perf_counter() - t0
    print(f"[wide] knapsack: {nh.nr_bdds()} BDDs, {nh.nr_vars()} variables, "
          f"{nh.nr_buckets()} raw buckets, built by the host library in {build_s:.2f} s "
          f"{card}", flush=True)
    if build_s > 60:
        fail(f"the host library took {build_s:.1f} s for the knapsack instance")
    for dtype in (torch.float32, torch.float64):
        host = layout.from_native_host(nh, dtype, "cuda")
        widths = sorted({g.P for g in host.geom.buckets})
        if not widths or widths[0] <= layout.NARROW_P:
            fail(f"the knapsack instance has buckets of widths {widths}; expected only wide ones")
        # the wide body as planned (one hop ahead, 8 warps a block), then at
        # other ring depths (0: every hop waits for its own copies, so what is
        # left is the coalesced layout alone), at four warps a block, and the
        # huge body forced on the same layout (below the crossover)
        kernel_vs_twin("knapsack", host, nh.objective(), card, errs, times, flush, suffix=WIDE,
                       variants=({"wide_stages": 0}, {"wide_stages": 2}, {"wide_stages": 4},
                                 {"wide_warps": 4}, {"body": "huge"}))
        del host
    # few columns: 40 rows make 40 columns of the same width, fewer than the
    # card has SMs; the plan gives each column a block of its own. Timed
    # beside other ring depths and beside 8 warps a block (5 SMs at work).
    few = NativeHost(knapsack_lp(nr_vars=400, nr_rows=40), "input")
    for dtype in (torch.float32, torch.float64):
        host = layout.from_native_host(few, dtype, "cuda")
        if min(g.P for g in host.geom.buckets) <= layout.NARROW_P:
            fail("the 40-row knapsack instance has a narrow bucket")
        kernel_vs_twin("knapsack40", host, few.objective(), card, errs, times, flush,
                       suffix=WIDE, variants=({"wide_stages": 0}, {"wide_stages": 8},
                                              {"wide_warps": 8}, {"body": "huge"}))
        del host
    cs = nh.cpu_solver()
    t0 = time.perf_counter()
    cs.iterations(KNAPSACK_ITERS, 0.5)
    native_s = time.perf_counter() - t0
    lb_native = cs.lower_bound_with_deferred()
    launches = {}
    for name, prec in (("float32", "float"), ("float64", "double")):
        sk.reset_launch_counts()
        twins_before = plain_calls()
        cfg = {"precision": prec, **DUAL_ONLY, **fixed_iterations(KNAPSACK_ITERS)}
        res = BddSolver(cfg, device="cuda").read_ilp(lp_string=lp).solve(verbose=False)
        rel = abs(res["lower_bound"] - lb_native) / abs(lb_native)
        counted = dict(sk.LAUNCHES)
        print(f"[wide] knapsack {name}: lb {res['lower_bound']!r} after {res['iterations']} "
              f"iterations vs the native C++ solver {lb_native!r}: rel diff {rel:.3e} (limit "
              f"{LB_REL[prec]}), solve {res['solve_time']} s (native {native_s:.2f} s); "
              f"launches {counted}; plain versions called "
              f"{ {k: plain_calls()[k] - twins_before[k] for k in twins_before} } {card}",
              flush=True)
        if res["status"] != "solved" or res["iterations"] != KNAPSACK_ITERS or not rel <= LB_REL[prec]:
            fail(f"knapsack {name} bound off the native solver")
        # the design: every bucket is wide, so a half-sweep is ONE launch, the
        # wide table's; no narrow launch and no twin on the card
        if sweeps_of(counted) != launch_counts(wide=KNAPSACK_ITERS) or counted[RUN]:
            fail(f"knapsack {name}: launches {counted}; expected "
                 f"{launch_counts(wide=KNAPSACK_ITERS)} and no narrow run")
        if plain_calls() != twins_before:
            fail(f"knapsack {name}: a plain sweep or run ran during the solve on the card")
        launches[name] = {"at": "knapsack", "dt": name, "suffix": WIDE, "launches": counted,
                          "iterations": res["iterations"]}
    return launches["float32"]


HUGE_ROWS = dict(nr_vars=1584, nr_rows=132, row_len=48, coef_max=1000)  # P = 16,384
WIDEST_ROWS = dict(nr_vars=1056, nr_rows=132, row_len=32, coef_max=1000)  # P = 8,192
# rows of 32 variables whose coefficients (up to the value) make BDDs of P
# slots, 132 of them over 256 columns (lane padding): the crossover between
# the wide body and the huge body
CROSSOVER_ROWS = {256: 25, 512: 50, 1024: 100, 2048: 250, 4096: 500}
# rows of 48 variables with coefficients up to 2,000: P = 32,768, past a
# block's shared memory in either precision (the cluster body)
L2_ROWS = dict(nr_vars=1584, nr_rows=132, row_len=48, coef_max=2000)
# up to 4,000: P = 65,536, past what four-byte slot codes hold: the cluster
# body with eight-byte codes; eight rows, so that their host build stays a
# few seconds
L2_WIDE_ROWS = dict(nr_vars=96, nr_rows=8, row_len=48, coef_max=4000)
# up to 16,000: P = 262,144, past what a cluster of 16 holds in float64 (the
# L2 body, its column over G blocks, with the form of one block a column
# beside it at 8-17 ms a launch: timed over a fifth of the launches), within
# it in float32; one row
L2_WIDEST_ROWS = dict(nr_vars=48, nr_rows=1, row_len=48, coef_max=16000)
HUGE_ITERS = 100  # cut from 200 (PR 8): the native solver's share of the phase
PATH_ITERS = 20  # iterations of the knapsack32 and L2 paths, counted for the kernels line
COUNTED_REPS = 40  # launches a counting entry and its uncounted one are each timed over
# the benchmark's mknap.t50.dual instance (portbench/configs/mknap_cb1.json,
# tightness 0.5): 5 rows of 32,768 slots on the L2 body at G = 26
MKNAP_T50 = dict(rows=5, items=100, tightness=0.5)
# and its mknap.t25.dual instance (tightness 0.25): 5 rows of 16,384 slots,
# which a block's shared memory holds, on the cluster body (clusters of 16)
# by their columns, their run on the L2 body
MKNAP_T25 = dict(rows=5, items=100, tightness=0.25)
MKNAP_SEED = 3_000_000_001
# the benchmark's gap_d60900.dual instance (portbench/configs/gap_d60900.json):
# 60 capacity rows of 1,024 slots over 900 hops on the shared-memory huge
# body (64 blocks), 900 assignment rows on the narrow body
GAP_D60900 = dict(agents=60, jobs=900, type="D")


def merged_lp(*lps: str) -> str:
    """One LP of the rows of every LP of ``knapsack_lp``'s form, each over
    variables (and rows) of its own: the k-th's are renamed with k."""
    objective, rows = [], []
    for k, lp in enumerate(lps):
        lines = re.sub(r"\bx(\d+)", rf"y{k}_\1", lp).splitlines()
        objective.append(lines[1])
        rows += [f"m{k}{line}" for line in lines[3:-1]]
    return "\n".join(["Minimize", " + ".join(objective), "Subject To", *rows, "End"])


def counted_iterations(label, host, objective, n, card, native=None,
                       rel_limit=LB_REL["double"]) -> dict:
    """``n`` iterations through the kernels on ``host`` from its initial
    state, counted: a path of the kernels line. Fails if a plain sweep or
    run ran, or, given ``native`` (the ``NativeHost`` the layout was built
    from), if the bound is off the native C++ solver's after as many
    iterations by more than ``rel_limit``."""
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf

    st = uf.init_uniform_state(host, objective)
    sk.reset_launch_counts()
    before = plain_calls()
    st = uf.iterations(host.geom, st, n, 0.5)
    lb = float(uf.lower_bound_with_deferred(host.geom, st))
    counted = dict(sk.LAUNCHES)
    if plain_calls() != before:
        fail(f"{label}: a plain sweep or run ran in its iterations on the card")
    print(f"[huge] {label}: {n} iterations through the kernels, bound {lb!r}, launches "
          f"{ {k: v for k, v in counted.items() if v} } {card}", flush=True)
    if native is not None:
        cs = native.cpu_solver()
        t0 = time.perf_counter()
        cs.iterations(n, 0.5)
        native_s = time.perf_counter() - t0
        lb_native = cs.lower_bound_with_deferred()
        rel = abs(lb - lb_native) / abs(lb_native)
        print(f"[huge] {label}: the native C++ solver after {n} iterations {lb_native!r} "
              f"({native_s:.2f} s): rel diff {rel:.3e} (limit {rel_limit}) {card}",
              flush=True)
        if not rel <= rel_limit:
            fail(f"{label}: bound {lb!r} off the native solver's {lb_native!r}")
    return counted


def crossover_rows(P: int, nr_rows: int, coef_max: int, card, flush) -> None:
    """:func:`crossover` on ``nr_rows`` knapsack rows of 32 variables whose
    coefficients (up to ``coef_max``) make BDDs of P slots, both precisions."""
    import torch
    from bdd_tpu_torch.native import NativeHost
    from bdd_tpu_torch.solver import layout

    rows = NativeHost(knapsack_lp(nr_vars=8 * nr_rows, nr_rows=nr_rows, row_len=32,
                                  coef_max=coef_max), "input")
    for dtype in (torch.float32, torch.float64):
        host = layout.from_native_host(rows, dtype, "cuda")
        if [g.P for g in host.geom.buckets] != [P]:
            fail(f"{nr_rows} crossover rows of coefficients up to {coef_max} have buckets "
                 f"{[(g.P, g.H, g.B) for g in host.geom.buckets]}; expected P = {P}")
        crossover(f"knapsack{P}" + ("" if nr_rows == 132 else f" x{nr_rows}"), host,
                  rows.objective(), card, flush)
        del host


def crossover(label, host, objective, card, flush) -> dict:
    """The wide body against the huge body on one layout of wide buckets, as
    it was built (lane padding included): forward, backward and run, each
    held to the plain versions bit for bit and timed warm and cold beside the
    byte bound; one ``[huge] crossover`` line."""
    import torch
    from bdd_tpu_torch.solver import layout
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf

    geom = host.geom
    dt = str(geom.dtype).replace("torch.", "")
    itemsize = torch.empty((), dtype=geom.dtype).element_size()
    st = uf.iterations(geom, uf.init_uniform_state(host, objective), 5)
    lo, hi, mm, cft = st.flat
    dl, dh = uf.exchange_delta_flat(geom, mm)
    ref_f = uf.sweep_per_bucket(uf.bucket_forward_iteration, geom, lo, hi, cft, 0.5, dl, dh)
    ref_b = uf.sweep_per_bucket(uf.bucket_backward_iteration, geom, ref_f[0], ref_f[1], ref_f[3],
                                0.5, dl, dh)
    ref_r = geom.flatten_nodes([uf.bucket_backward_run(g, a, b) for g, a, b in zip(
        geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))])
    shapes = bdd_shapes(geom.buckets)
    bound = {"fwd": launch_bytes(shapes, itemsize, True), "bwd": launch_bytes(shapes, itemsize, False),
             "run": run_bytes(shapes, itemsize)}
    out = {}
    for body in ("wide", "huge"):
        plan = variant_plan(geom.plan.shapes, geom.dtype, geom.device, body)
        if [r.body for r in plan.sweeps] != ["_" + body]:
            fail(f"{label} {dt}: the {body} variant's plan launches {plan_text(plan)}")
        launches = {"fwd": sk.prepare_fused_launch("uniform_forward", geom, lo, hi, cft, 0.5, dl,
                                                   dh, plan),
                    "bwd": sk.prepare_fused_launch("uniform_backward", geom, ref_f[0], ref_f[1],
                                                   ref_f[3], 0.5, dl, dh, plan),
                    "run": sk.prepare_run_launch(geom, lo, hi, plan)}
        for key, (launch, res) in launches.items():
            launch()
            torch.cuda.synchronize()
            compare(res if key != "run" else [res],
                    {"fwd": ref_f, "bwd": ref_b, "run": [ref_r]}[key], TOL[dt])
            out[(body, key)] = (cuda_ms(launch, 100), cuda_ms(launch, 10, flush))
        if body == "huge":
            threads = plan.sweeps[0].threads
    route = geom.plan.sweeps[0].body[1:]
    print(f"[huge] crossover {label} P={geom.plan.shapes[0][0]} {dt} (buckets "
          f"{[tuple(x) for x in geom.plan.shapes]}, {sum(B for _, _, B in shapes)} columns with a "
          f"BDD): match; " + "; ".join(
              f"{key} bound {1e3 * bound[key] / HBM_BYTES_PER_S:.4f} ms, wide "
              f"{out[('wide', key)][0]:.4f} / {out[('wide', key)][1]:.4f} ms, huge "
              f"{out[('huge', key)][0]:.4f} / {out[('huge', key)][1]:.4f} ms (warm / cold)"
              for key in ("fwd", "bwd", "run"))
          + f"; huge {threads} threads a block; the plan routes it to the {route} body {card}",
          flush=True)
    return out


def same_bits(a, b) -> bool:
    """Whether two tensors of one dtype hold the same bit patterns (NaN and
    signed zeros included)."""
    import torch

    view = {torch.float32: torch.int32, torch.float64: torch.int64}.get(a.dtype, a.dtype)
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def counted_vs_plain(label, host, objective, card, errs, times, reps=COUNTED_REPS,
                     body=HUGE_L2) -> dict:
    """A body's counting entries (``_count``: the launch the wrapper takes
    while a profiler records), the L2 body's (``body`` HUGE_L2) or the
    shared-memory huge body's (HUGE; every profiled launch counted here,
    its COUNT_EVERY 1), on a layout that has blocks of it, under a
    CPU-only torch.profiler: the fused forward and backward from the state of
    five iterations and the run-only entry, each entry of the body the plan
    has, against the plain versions at TOL and bit for bit against the
    uncounted launch; the barrier wait strictly between 0 and the block
    cycles, except on the L2 body where a column has one block (0 there); one
    launch each of the counting entries counted (``sweep_kernels.COUNTED``);
    each timed beside the uncounted launch in turns
    (uncounted, counted, counted, uncounted). Returns the path of the kernels
    line (suffix ``body`` + "_count")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bdd_tpu_torch.solver import layout
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf

    geom, plan = host.geom, host.geom.plan
    dt = str(geom.dtype).replace("torch.", "")
    itemsize = torch.empty((), dtype=geom.dtype).element_size()
    st = uf.iterations(geom, uf.init_uniform_state(host, objective), 5)
    lo, hi, mm, cft = st.flat
    dl, dh = uf.exchange_delta_flat(geom, mm)
    dl_b, dh_b = geom.per_bucket(dl), geom.per_bucket(dh)

    def cat(outs):  # as the fused wrappers lay them: the frontier in storage order
        new_lo, new_hi, new_mm, frontier = zip(*outs)
        return (layout.flatten(new_lo), layout.flatten(new_hi), layout.flatten(new_mm),
                geom.flatten_nodes(frontier))

    ref_f = [uf.bucket_forward_iteration(g, st.lo[k], st.hi[k], st.cft[k], 0.5, dl_b[k], dh_b[k])
             for k, g in enumerate(geom.buckets)]
    ref_b = cat([uf.bucket_backward_iteration(g, r[0], r[1], r[3], 0.5, dl_b[k], dh_b[k])
                 for (k, g), r in zip(enumerate(geom.buckets), ref_f)])
    ref_f = cat(ref_f)
    ref_run = [geom.flatten_nodes([uf.bucket_backward_run(g, a, b) for g, a, b in zip(
        geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))])]
    shapes = bdd_shapes(geom.buckets)
    on = [next((r for r in rs if r.body == body), None) for rs in (plan.sweeps, plan.runs)]
    # blocks a column: the L2 body's G, the huge body's one
    splits = [r.own[0] if body == HUGE_L2 and r else 1 for r in on]
    wait_of = sk.huge_wait_cycles if body == HUGE else sk.l2_wait_cycles
    entries = []
    if on[0]:
        entries += [
            ("uniform_forward", splits[0], ref_f, launch_bytes(shapes, itemsize, True),
             sk.prepare_fused_launch("uniform_forward", geom, lo, hi, cft, 0.5, dl, dh)),
            ("uniform_backward", splits[0], ref_b, launch_bytes(shapes, itemsize, False),
             sk.prepare_fused_launch("uniform_backward", geom, ref_f[0], ref_f[1], ref_f[3],
                                     0.5, dl, dh))]
    if on[1]:
        entries.append((RUN, splits[1], ref_run, run_bytes(shapes, itemsize),
                        sk.prepare_run_launch(geom, lo, hi)))
    if not entries:
        fail(f"{label} {dt}: no {body[1:]} block in the plan")
    entry = times.setdefault((f"{label} counted", dt), {})
    suffix = body + "_count"
    launches, row = {}, []
    every = sk.COUNT_EVERY[body]
    sk.COUNT_EVERY[body] = 1
    try:
        for name, split, ref, nbytes, (launch, out) in entries:
            outs = [out] if name == RUN else list(out)
            launch()
            torch.cuda.synchronize()
            uncounted = [o.clone() for o in outs]
            key = name + suffix
            n0, (w0, c0) = sk.COUNTED[body, name], wait_of()[name]
            with profile(activities=[ProfilerActivity.CPU]):
                launch()
                torch.cuda.synchronize()
                n1, (w1, c1) = sk.COUNTED[body, name], wait_of()[name]
            wait, cycles = w1 - w0, c1 - c0
            if n1 - n0 != 1:
                fail(f"{label} {dt} {name}: {n1 - n0} counting launches under the profiler, "
                     f"not 1 (the counting entries hold fewer blocks an SM than the body's?)")
            errs[key] = max(errs.get(key, 0.0), compare(outs, ref, TOL[dt]))
            if not all(same_bits(a, b) for a, b in zip(outs, uncounted)):
                fail(f"{label} {dt} {name}: the counting launch differs from the uncounted one")
            if not (cycles > 0 and (wait == 0 if body == HUGE_L2 and split == 1
                                    else 0 < wait < cycles)):
                fail(f"{label} {dt} {name}: barrier wait {wait} of {cycles} block cycles at "
                     f"{split} block(s) a column")
            turns = {"uncounted": [cuda_ms(launch, reps)]}
            with profile(activities=[ProfilerActivity.CPU]):
                turns["counted"] = [cuda_ms(launch, reps), cuda_ms(launch, reps)]
            turns["uncounted"].append(cuda_ms(launch, reps))
            counted_ms, uncounted_ms = (sum(turns[k]) / 2 for k in ("counted", "uncounted"))
            cost = 100.0 * (counted_ms / uncounted_ms - 1)
            launches[key] = n1 - n0
            entry[name] = {"ms": counted_ms, "cold_ms": None, "plain_ms": None, "bytes": nbytes,
                           "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                           "uncounted_ms": uncounted_ms, "wait_pct": 100.0 * wait / cycles}
            row.append(f"{name} at {split} a column: wait {100.0 * wait / cycles:.2f}% of "
                       f"{cycles} cycles, counted {counted_ms:.4f} ms against {uncounted_ms:.4f} "
                       f"uncounted ({cost:+.2f}%"
                       + (f"; {cost / every:+.3f}% of the body's time at one launch in {every}"
                          if body == HUGE else "") + ")")
    finally:
        sk.COUNT_EVERY[body] = every
    print(f"[counted] {label} {dt} {body[1:]} counting entries under a CPU-only profiler: match "
          f"the plain versions and the uncounted launches bit for bit; {'; '.join(row)} {card}",
          flush=True)
    return {"at": f"{label} counted", "dt": dt, "suffix": suffix, "launches": launches,
            "iterations": 0, "entries": tuple(name for name, *_ in entries)}


def gap_counted(card, errs, times) -> dict:
    """The shared-memory huge body's counting entries (``counted_vs_plain``)
    on the benchmark's gap_d60900.dual layout (float32, packed as the harness
    builds it): 64 blocks of 1,024 slots over 900 hops, the assignment rows
    on the narrow body beside them."""
    import torch
    from bdd_tpu_torch.native import NativeHost
    from bdd_tpu_torch.solver import layout
    from portbench.generators import yagiura_gap

    t0 = time.perf_counter()
    gap = NativeHost(yagiura_gap.make(GAP_D60900, MKNAP_SEED).lp_text(), "input")
    host = layout.from_native_host(gap, torch.float32, "cuda")
    plan = host.geom.plan
    print(f"[huge] gap_d60900 float32 (seed {MKNAP_SEED}): buckets (P, H, B) "
          f"{[tuple(s) for s in plan.shapes]}, {blocks_of(plan, HUGE)} blocks of the huge body, "
          f"{blocks_of(plan, '')} of the narrow body, built in {time.perf_counter() - t0:.2f} s "
          f"{card}", flush=True)
    if [(r.body, r.blocks) for r in plan.sweeps if r.body] != [(HUGE, 64)]:
        fail(f"gap_d60900's rows {plan.shapes} do not take the huge body by the route")
    return counted_vs_plain("gap_d60900", host, gap.objective(), card, errs, times, body=HUGE)


# the ring form's depths timed on the gap_d60900 layout (``layout.build_plan``'s
# ``ring_hops``): layout.HUGE_RING_HOPS is the one chosen from them
RING_DEPTHS = (1, 2, 3, 4)


def gap_forms(card, errs, times, flush, reps=20) -> list:
    """The benchmark's gap_d60900.dual layout (float32, packed as the harness
    builds it: 64 columns of 1,024 slots over 900 hops on the shared-memory
    huge body, one slot a thread): its route's ring form and the grouped body
    forced on the same table (``ring_hops=0``), all three entries, each
    launch held to the plain versions and to the other form bit for bit and
    timed warm and cold in turns (ring, grouped, grouped, ring) beside the
    byte bound; then the ring at every depth of RING_DEPTHS (a forced
    ``ring_hops``), bit for bit, timed in turns with the route's depth.
    Returns the two paths of the kernels line ("gap_d60900 ring",
    "gap_d60900 grouped"; the launches one an entry)."""
    import torch
    from bdd_tpu_torch.native import NativeHost
    from bdd_tpu_torch.solver import layout
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf
    from portbench.generators import yagiura_gap

    gap = NativeHost(yagiura_gap.make(GAP_D60900, MKNAP_SEED).lp_text(), "input")
    host = layout.from_native_host(gap, torch.float32, "cuda")
    geom, route = host.geom, host.geom.plan
    ring = route.launch("huge")
    if (ring.blocks, ring.own[1]) != (64, layout.HUGE_RING_HOPS):
        fail(f"gap_d60900's rows {route.shapes} take {ring.blocks} huge blocks at ring "
             f"depth {ring.own[1]}; expected 64 on the ring form")
    st = uf.iterations(geom, uf.init_uniform_state(host, gap.objective()), 5)
    lo, hi, mm, cft = st.flat
    dl, dh = uf.exchange_delta_flat(geom, mm)
    ref_f = uf.sweep_per_bucket(uf.bucket_forward_iteration, geom, lo, hi, cft, 0.5, dl, dh)
    ref_b = uf.sweep_per_bucket(uf.bucket_backward_iteration, geom, ref_f[0], ref_f[1],
                                ref_f[3], 0.5, dl, dh)
    refs = {"uniform_forward": ref_f, "uniform_backward": ref_b, RUN: [geom.flatten_nodes([
        uf.bucket_backward_run(g, a, b)
        for g, a, b in zip(geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))])]}
    shapes = bdd_shapes(geom.buckets)
    bounds = {"uniform_forward": launch_bytes(shapes, 4, True),
              "uniform_backward": launch_bytes(shapes, 4, False), RUN: run_bytes(shapes, 4)}

    def launches(plan):
        """entry -> (launch, its outputs as a list), each checked once:
        counted, bit for bit against the plain versions"""
        out = {
            "uniform_forward": sk.prepare_fused_launch("uniform_forward", geom, lo, hi, cft, 0.5,
                                                       dl, dh, plan),
            "uniform_backward": sk.prepare_fused_launch("uniform_backward", geom, ref_f[0],
                                                        ref_f[1], ref_f[3], 0.5, dl, dh, plan),
            RUN: sk.prepare_run_launch(geom, lo, hi, plan)}
        out = {k: (launch, [res] if k == RUN else list(res)) for k, (launch, res) in out.items()}
        for name, (launch, res) in out.items():
            sk._launch_counted(launch)
            torch.cuda.synchronize()
            errs[name + HUGE] = max(errs[name + HUGE], compare(res, refs[name], TOL["float32"]))
            if not all(same_bits(a, b) for a, b in zip(res, refs[name])):
                fail(f"gap_d60900 {name} at ring depth {plan.launch('huge').own[1]}: not bit "
                     f"for bit the plain version's")
        return out

    forms = {"ring": route,
             "grouped": variant_plan(route.shapes, torch.float32, "cuda", ring_hops=0)}
    if forms["grouped"].launch("huge").own[1] != 0:
        fail("ring_hops=0 left the gap layout on the ring form")
    paths = []
    for form, plan in forms.items():
        sk.reset_launch_counts()
        forms[form] = launches(plan)
        rings = dict(sk.HUGE_RING)
        if rings != {k: int(form == "ring") for k in rings}:
            fail(f"gap_d60900 {form}: HUGE_RING counted {rings}")
        paths.append({"at": f"gap_d60900 {form}", "dt": "float32", "suffix": HUGE,
                      "launches": {k + HUGE: sk.LAUNCHES[k + HUGE] for k in refs},
                      "iterations": 0})
    for name in refs:
        turns = {"ring": [], "grouped": []}
        for form in ("ring", "grouped", "grouped", "ring"):
            launch = forms[form][name][0]
            turns[form].append((cuda_ms(launch, reps), cuda_ms(launch, max(2, reps // 10), flush)))
        bound_ms = 1e3 * bounds[name] / HBM_BYTES_PER_S
        for form, ms in turns.items():
            warm, cold = (sum(x[i] for x in ms) / len(ms) for i in (0, 1))
            times.setdefault((f"gap_d60900 {form}", "float32"), {})[name] = {
                "ms": warm, "cold_ms": cold, "plain_ms": None, "bytes": bounds[name],
                "bound_ms": bound_ms}
        print(f"[ring] gap_d60900 float32 {name} (buckets {[tuple(s) for s in route.shapes]}): "
              f"both forms match the plain versions bit for bit; in turns ring / grouped / "
              f"grouped / ring warm "
              + " / ".join(f"{turns[f][i][0]:.4f}" for f, i in (("ring", 0), ("grouped", 0),
                                                                ("grouped", 1), ("ring", 1)))
              + f" ms, cold {turns['ring'][0][1]:.4f} / {turns['grouped'][0][1]:.4f} ms; bound "
              f"{bound_ms:.4f} ms; ring {100 * bound_ms / turns['ring'][0][0]:.2f}% of it, "
              f"grouped {100 * bound_ms / turns['grouped'][0][0]:.2f}%; ring depth "
              f"{ring.own[1]}, smem {ring.smem_forward} / {ring.smem_backward} B "
              f"{card}", flush=True)
    # the depths: each against the route's, in turns
    for hops in RING_DEPTHS:
        deep = launches(variant_plan(route.shapes, torch.float32, "cuda", ring_hops=hops))
        row = []
        for name in refs:
            ms = {}
            for which, launch in (("route", forms["ring"][name][0]), ("depth", deep[name][0]),
                                  ("depth", deep[name][0]), ("route", forms["ring"][name][0])):
                ms.setdefault(which, []).append(cuda_ms(launch, reps))
            row.append(f"{name} {sum(ms['depth']) / 2:.4f} ms (route's "
                       f"{sum(ms['route']) / 2:.4f})")
        print(f"[ring] gap_d60900 float32 depth {hops}: bit for bit; in turns with the route's "
              f"depth {ring.own[1]}: {'; '.join(row)} {card}", flush=True)
    del host, geom, forms, refs
    torch.cuda.empty_cache()
    return paths


def phase_huge(card, errs, times, flush):
    """Phase 6, huge rows: knapsack rows wider than 8,192 slots through the
    huge body (a block a column, rows in shared memory, a launch of its own
    per half-sweep); rows of exactly 8,192 on the body the route gives them,
    beside the wide body (the crossover; at 256 to 4,096 slots: ``--huge-split
    columns``); knapsack48 and those rows in one layout; rows past a block's
    shared memory on the bodies the route gives them by their columns, the
    other body forced beside them: 132 rows of 32,768 slots sweep on the
    cluster body and run on the L2 body, 8 rows of 65,536 slots (eight-byte
    slot codes in the cluster body) and a row of 262,144 take the L2 body
    (its column over the plan's G blocks; in float64, past any cluster, the
    form of one block a column forced beside it); on each layout with L2
    blocks, and on the benchmark's mknap.t50.dual layout, the L2 body's
    counting entries (``counted_vs_plain``), and the shared-memory huge
    body's on knapsack48 and the benchmark's gap_d60900.dual layout
    (``gap_counted``; the ring form's there); the benchmark's mknap.t25.dual
    layout (5 rows a block holds) on the cluster body by the route, the huge
    and the L2 body forced beside it, and its run's counting entry. Returns the paths of the
    kernels line: knapsack48's float64 solve, knapsack32's, the counted
    float64 iterations of the 32,768-, 65,536- and 262,144-slot rows, the
    counted float32 ones of the 262,144-slot row, and the counting entries'
    launches on each of those layouts and on knapsack48 and gap_d60900."""
    import torch
    from bdd_tpu_torch.api import BddSolver
    from bdd_tpu_torch.native import NativeHost
    from bdd_tpu_torch.solver import layout
    from bdd_tpu_torch.solver import sweep_kernels as sk

    paths = []
    t0 = time.perf_counter()
    lp = knapsack_lp(**HUGE_ROWS)
    nh = NativeHost(lp, "input")
    print(f"[huge] knapsack rows {HUGE_ROWS}: {nh.nr_bdds()} BDDs, {nh.nr_vars()} variables, "
          f"built by the host library in {time.perf_counter() - t0:.2f} s {card}", flush=True)
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        # unpacked in float32 too: packing keeps one BDD a column here (the
        # same shapes) and took 42 s of host time over the 1.6 GB of arc
        # arrays on the card machine's host (NVIDIA H100 80GB HBM3, 700 W)
        host = layout.from_native_host(nh, dtype, "cuda", pack=False)
        shapes = [(g.P, g.H, g.B) for g in host.geom.buckets]
        columns = sum(int((d > 0).sum()) for d in host.depths)
        plan = host.geom.plan
        print(f"[huge] knapsack48 {dtype}: buckets (P, H, B) {shapes}, {columns} columns with a "
              f"BDD, arc record {layout.record_bytes(shapes[0][0])} B a hop and column, layout "
              f"built in {time.perf_counter() - t0:.2f} s; {buckets_of(plan, HUGE)} bucket(s) on "
              f"the shared-memory huge body, {buckets_of(plan, HUGE_L2)} on the L2 body {card}",
              flush=True)
        if (min(P for P, _, _ in shapes) <= layout.WIDE_P or columns < 132
                or sum(B for _, _, B in shapes) != columns
                or buckets_of(plan, HUGE) != len(shapes)):
            fail(f"the huge knapsack family has buckets {shapes}, {columns} columns; expected "
                 f"only P > {layout.WIDE_P} and at least 132 columns, none of them padding, "
                 f"all on the shared-memory huge body")
        kernel_vs_twin("knapsack48", host, nh.objective(), card, errs, times, flush, suffix=HUGE)
        paths.append(counted_vs_plain("knapsack48", host, nh.objective(), card, errs, times,
                                      body=HUGE))
        del host
    paths.append(gap_counted(card, errs, times))
    # rows of 8,192 slots: the body the route gives them, the wide body beside it
    widest_lp = knapsack_lp(**WIDEST_ROWS)
    widest = NativeHost(widest_lp, "input")
    for dtype in (torch.float32, torch.float64):
        host = layout.from_native_host(widest, dtype, "cuda")
        shapes = [(g.P, g.H, g.B) for g in host.geom.buckets]
        suffix = host.geom.plan.sweeps[0].body
        route = suffix[1:]
        if [P for P, _, _ in shapes] != [layout.WIDE_P]:
            fail(f"the P = {layout.WIDE_P} knapsack family has buckets {shapes}")
        print(f"[huge] knapsack32 {dtype}: buckets (P, H, B) {shapes}: routed to the {route} body "
              f"{card}", flush=True)
        crossover("knapsack32", host, widest.objective(), card, flush)
        kernel_vs_twin("knapsack32", host, widest.objective(), card, errs, times, flush,
                       suffix=suffix)
        if dtype == torch.float32:
            counted = counted_iterations("knapsack32 float32", host, widest.objective(),
                                         PATH_ITERS, card)
            body = {"wide": dict(wide=PATH_ITERS), "huge": dict(huge=PATH_ITERS)}[route]
            if sweeps_of(counted) != launch_counts(**body):
                fail(f"knapsack32: launches {counted}; expected {launch_counts(**body)}")
            paths.append({"at": "knapsack32", "dt": "float32", "suffix": suffix,
                          "launches": counted, "iterations": PATH_ITERS})
        del host
    # knapsack48 and the rows of 8,192 slots in one layout (388 columns in one
    # huge table)
    mixed = NativeHost(merged_lp(lp, widest_lp), "input")
    host = layout.from_native_host(mixed, torch.float32, "cuda", pack=False)
    plan = host.geom.plan
    shapes = [(g.P, g.H, g.B) for g in host.geom.buckets]
    print(f"[huge] knapsack48 + knapsack32 float32: buckets (P, H, B) {shapes}, "
          f"{plan_text(plan)} {card}", flush=True)
    if sorted(P for P, _, _ in shapes) != [layout.WIDE_P, 16384] or buckets_of(plan, HUGE) != 2:
        fail(f"the merged knapsack layout has buckets {shapes}, {buckets_of(plan, HUGE)} on the "
             f"huge body")
    kernel_vs_twin("knapsack48+32", host, mixed.objective(), card, errs, times, flush,
                   suffix=HUGE)
    del host, mixed
    # rows past a block's shared memory in either precision, on the bodies
    # the route gives them (layout.route, by their columns as
    # well as their width) with the other body forced beside them: 132 rows of 32,768
    # slots (four-byte slot codes) sweep on the cluster body and run on the
    # L2 body; 8 rows of 65,536 (eight-byte codes) and one of 262,144 take
    # the L2 body in all three entries (beside the float64 row, past any
    # cluster, its form of one block a column instead). Counted iterations:
    # both precisions of the widest row (float32 is the default), float64 of
    # the others.
    on_l2, on_cluster = {"body": "huge_l2"}, {"body": "huge_cluster"}
    for label, rows, runs, reps in (
            ("knapsack48 L2", L2_ROWS,
             ((torch.float32, HUGE_CLUSTER, HUGE_L2, (on_l2, on_cluster), False),
              (torch.float64, HUGE_CLUSTER, HUGE_L2, (on_l2, on_cluster), True)), 100),
            ("knapsack L2 wide", L2_WIDE_ROWS,
             ((torch.float32, HUGE_L2, HUGE_L2, (on_cluster,), False),
              (torch.float64, HUGE_L2, HUGE_L2, (on_cluster,), True)), 200),
            ("knapsack L2 widest", L2_WIDEST_ROWS,
             ((torch.float32, HUGE_L2, HUGE_L2, (on_cluster,), True),
              (torch.float64, HUGE_L2, HUGE_L2, ({"l2_split": 1},), True)), 40)):
        t0 = time.perf_counter()
        l2 = NativeHost(knapsack_lp(**rows), "input")
        print(f"[huge] knapsack rows {rows}: {l2.nr_bdds()} BDDs, built by the host library in "
              f"{time.perf_counter() - t0:.2f} s {card}", flush=True)
        for dtype, suffix, run_suffix, variants, count in runs:
            itemsize = torch.empty((), dtype=dtype).element_size()
            dt = str(dtype).replace("torch.", "")
            host = layout.from_native_host(l2, dtype, "cuda", pack=False)
            plan = host.geom.plan
            shapes = [(g.P, g.H, g.B) for g in host.geom.buckets]
            print(f"[huge] {label} {dt}: buckets (P, H, B) {shapes}, "
                  f"{layout.huge_smem_bytes(shapes[0][0], itemsize)} B of shared memory a block at "
                  f"the least (a block may have {layout.MAX_DYNAMIC_SMEM}): {plan_text(plan)} "
                  f"{card}", flush=True)
            if ([(r.body, r.nr_buckets) for r in plan.sweeps] != [(suffix, len(shapes))]
                    or [(r.body, r.nr_buckets) for r in plan.runs] != [(run_suffix, len(shapes))]):
                fail(f"the {label} rows do not all sweep on the {suffix[1:]} body and run on the "
                     f"{run_suffix[1:]} body: {shapes}, {plan_text(plan)}")
            kernel_vs_twin(label, host, l2.objective(), card, errs, times, flush, suffix=suffix,
                           variants=variants, reps=reps, run_suffix=run_suffix)
            paths.append(counted_vs_plain(label, host, l2.objective(), card, errs, times))
            if suffix == HUGE_L2:
                e, hops = times[(label, dt)], max(H for _, H, _ in plan.shapes)
                rec = launch_of(plan, HUGE_L2)
                print(f"[huge] {label} {dt} L2 body: {rec.own[0]} blocks a column over "
                      f"{rec.own[1]} column(s), {rec.blocks} blocks of "
                      f"{rec.threads} threads; a hop (of {hops}) "
                      + ", ".join(f"{k} {e[k]['ms'] / hops:.4f} ms" for k in (
                          "uniform_forward", "uniform_backward", RUN)) + f" {card}", flush=True)
            if count:
                prec = "float" if dtype == torch.float32 else "double"
                counted = counted_iterations(f"{label} {dt}", host, l2.objective(), PATH_ITERS,
                                             card, native=l2, rel_limit=LB_REL[prec])
                want = launch_counts(**{suffix[1:]: PATH_ITERS})
                if sweeps_of(counted) != want or not counted[RUN + run_suffix] or any(
                        counted[RUN + b] for b in BODIES if b != run_suffix):
                    fail(f"{label} {dt}: launches {counted}; expected {want} and runs of the "
                         f"{run_suffix[1:]} body only")
                paths.append({"at": label, "dt": dt, "suffix": suffix, "run_suffix": run_suffix,
                              "launches": counted, "iterations": PATH_ITERS})
            del host
        del l2
    # the benchmark's mknap.t50.dual layout, whose traced runs take the
    # counting entries
    from portbench.generators import chu_beasley

    mknap = NativeHost(chu_beasley.make(MKNAP_T50, MKNAP_SEED).lp_text(), "input")
    host = layout.from_native_host(mknap, torch.float32, "cuda")
    plan = host.geom.plan
    print(f"[huge] mknap.t50 float32 (seed {MKNAP_SEED}): buckets (P, H, B) "
          f"{[tuple(s) for s in plan.shapes]}, {plan_text(plan)} {card}", flush=True)
    paths.append(counted_vs_plain("mknap.t50", host, mknap.objective(), card, errs, times))
    del host, mknap
    # the benchmark's mknap.t25.dual layout (float32, packed as the harness
    # builds it): rows a block holds over 5 columns, on the cluster body by
    # the route and their run on the L2 body, the shared-memory huge body and
    # the L2 body forced beside it; the run's counting entry
    mknap = NativeHost(chu_beasley.make(MKNAP_T25, MKNAP_SEED).lp_text(), "input")
    host = layout.from_native_host(mknap, torch.float32, "cuda")
    plan = host.geom.plan
    print(f"[huge] mknap.t25 float32 (seed {MKNAP_SEED}): buckets (P, H, B) "
          f"{[tuple(s) for s in plan.shapes]}, {plan_text(plan)} {card}", flush=True)
    if ([(r.body, r.nr_buckets) for r in plan.sweeps + plan.runs]
            != [(HUGE_CLUSTER, 1), (HUGE_L2, 1)]):
        fail(f"mknap.t25's rows {plan.shapes} do not take the cluster body by the route")
    kernel_vs_twin("mknap.t25", host, mknap.objective(), card, errs, times, flush,
                   variants=({"body": "huge"}, {"body": "huge_l2"}),
                   suffix=HUGE_CLUSTER, run_suffix=HUGE_L2)
    paths.append(counted_vs_plain("mknap.t25", host, mknap.objective(), card, errs, times))
    del host, mknap
    cs = nh.cpu_solver()
    t0 = time.perf_counter()
    cs.iterations(HUGE_ITERS, 0.5)
    native_s = time.perf_counter() - t0
    lb_native = cs.lower_bound_with_deferred()
    # the solve in float64 (the precision a solve of rows of such
    # coefficients needs; a float32 solve agreed with the native solver to
    # 1.1e-7 relative, and its layout build doubles this phase)
    for name, prec in (("float64", "double"),):
        sk.reset_launch_counts()
        twins_before = plain_calls()
        cfg = {"precision": prec, **DUAL_ONLY, **fixed_iterations(HUGE_ITERS)}
        t0 = time.perf_counter()
        res = BddSolver(cfg, device="cuda").read_ilp(lp_string=lp).solve(verbose=False)
        wall = time.perf_counter() - t0
        rel = abs(res["lower_bound"] - lb_native) / abs(lb_native)
        counted = dict(sk.LAUNCHES)
        print(f"[huge] knapsack48 {name}: lb {res['lower_bound']!r} after {res['iterations']} "
              f"iterations vs the native C++ solver {lb_native!r}: rel diff {rel:.3e} (limit "
              f"{LB_REL[prec]}), solve {res['solve_time']} s = "
              f"{1e3 * res['solve_time'] / res['iterations']:.4f} ms per iteration, {wall:.2f} s "
              f"wall (native {native_s:.2f} s); launches {counted}; plain versions called "
              f"{ {k: plain_calls()[k] - twins_before[k] for k in twins_before} } {card}",
              flush=True)
        if res["status"] != "solved" or res["iterations"] != HUGE_ITERS or not rel <= LB_REL[prec]:
            fail(f"huge knapsack {name} bound off the native solver")
        # every bucket is huge: a half-sweep is ONE launch, the huge table's
        if (sweeps_of(counted) != launch_counts(huge=HUGE_ITERS) or not counted[RUN + HUGE]
                or any(counted[RUN + b] for b in BODIES if b != HUGE)):
            fail(f"huge knapsack {name}: launches {counted}; expected "
                 f"{launch_counts(huge=HUGE_ITERS)} and runs of the huge body only")
        if plain_calls() != twins_before:
            fail(f"huge knapsack {name}: a plain sweep or run ran during the solve on the card")
    return [{"at": "knapsack48", "dt": "float64", "suffix": HUGE, "launches": counted,
             "iterations": res["iterations"]}] + paths


MIS200 = dict(nr_nodes=200, edge_prob=0.15, seed=0)  # the MIS-200 rows of BENCH.md:419-420
TIGHTEN_ITERS = 1000


def phase_tighten(card, errs, times, flush):
    """Phase 11: the cut-tightening phase (clique facets) on MIS-200, on the
    card and, for the bound, on the CPU."""
    from bdd_tpu_torch.api import BddSolver
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.utils.problems import independent_set

    cfg = {"relaxation solver": "uniform mma", "precision": "double", "variable order": "bfs",
           "tighten": {"cliques": True}, **DUAL_ONLY, **fixed_iterations(TIGHTEN_ITERS)}
    results = {}
    for device in ("cuda", "cpu"):
        sk.reset_launch_counts()
        before = plain_calls()
        t0 = time.perf_counter()
        s = BddSolver(dict(cfg), device=device).read_ilp(ilp=independent_set(**MIS200))
        res = s.solve(verbose=False)
        wall = time.perf_counter() - t0
        st, tb = s.tighten_stats, res.get("tighten")
        if res["status"] != "solved" or tb is None:
            fail(f"tighten MIS-200 on {device}: {str(res)[:300]}")
        results[device] = (s, res, dict(sk.LAUNCHES), wall)
        print(f"[tighten] MIS-200 float64 on {device}: BDDs {st['bdds_before']} -> "
              f"{st['bdds_after']}, {st['groups_melded']} groups melded, "
              f"{st['tight_variables']} tight variables; bound {tb['pre_lower_bound']!r} -> "
              f"{tb['post_lower_bound']!r} (warm start {st['warm_lower_bound']!r}); wall "
              f"{wall:.2f} s: dual {st['dual_s']:.3f} s, min-marginals and export "
              f"{st['min_marginals_s']:.3f} s, meld {st['meld_s']:.3f} s, rebuild "
              f"{st['rebuild_s']:.3f} s, re-solve {st['resolve_s']:.3f} s; launches "
              f"{dict(sk.LAUNCHES)}; plain versions "
              f"{ {k: plain_calls()[k] - before[k] for k in before} } {card}", flush=True)
        if device == "cuda":
            if plain_calls() != before:
                fail(f"tighten MIS-200: plain versions ran on the card: {before} -> "
                     f"{plain_calls()}")
            if not tb["post_lower_bound"] > tb["pre_lower_bound"]:
                fail(f"tighten MIS-200: the bound did not rise: {tb}")
            if st["warm_lower_bound"] < tb["pre_lower_bound"] - 1e-9 * abs(tb["pre_lower_bound"]):
                fail(f"tighten MIS-200: the warm start fell below the converged bound: "
                     f"{st['warm_lower_bound']!r} < {tb['pre_lower_bound']!r}")
    (s, res, counted, _), (_, cpu, _, _) = results["cuda"], results["cpu"]
    for key in ("pre_lower_bound", "post_lower_bound"):
        a, b = res["tighten"][key], cpu["tighten"][key]
        if not abs(a - b) <= 1e-9 * abs(b):
            fail(f"tighten MIS-200 {key}: card {a!r} vs CPU {b!r} (rel > 1e-9)")
    iterations = s.tighten_stats["dual_iterations"] + res["iterations"]
    if sweeps_of(counted) != launch_counts(narrow=iterations):
        fail(f"tighten MIS-200: launches {counted}; expected one narrow launch per kernel and "
             f"iteration of the two solves ({iterations})")
    print(f"[tighten] MIS-200: card and CPU bounds agree to rel 1e-9; the bound rose by "
          f"{res['tighten']['post_lower_bound'] - res['tighten']['pre_lower_bound']:.6f} {card}",
          flush=True)
    # the kernels against the twins on the melded layout, from its solved state
    kernel_vs_twin("tighten mis200", s.solver.host, None, card, errs, times, flush,
                   state=s.solver.state)
    return {"at": "tighten mis200", "dt": "float64", "suffix": "", "launches": counted,
            "iterations": iterations}


MATCHING_3X3 = """Minimize
-2 x_11 - 1 x_12 - 1 x_13 - 1 x_21 - 2 x_22 - 1 x_23 - 1 x_31 - 1 x_32 - 2 x_33
Subject To
x_11 + x_12 + x_13 = 1
x_21 + x_22 + x_23 = 1
x_31 + x_32 + x_33 = 1
x_11 + x_21 + x_31 = 1
x_12 + x_22 + x_32 = 1
x_13 + x_23 + x_33 = 1
End"""  # tests/fixtures.py: a 3x3 assignment, LP-tight at -6
SMOOTH_CFG = {"relaxation solver": "smooth mma", "smoothing": 0.2, "smoothing decay factor": 0.5}
SMOOTH_ITERS = 50  # depth cut from 200 to keep the whole script in its time budget
GM_SMOOTH_ITERS = 20
SMOOTH_FIXED_T_ITERS = 15  # grid12 at a fixed temperature: depth cut from 30


def perturb_zero_sum(s, magnitude=1.7) -> None:
    """Move a solver's dual point without changing the relaxation: per
    variable with two layers or more, +magnitude on one layer's hi cost and
    -magnitude on another's (tests/test_smooth_mma.py)."""
    import numpy as np

    lv, valid = s.f.layer_var, s.f.valid_layer_mask()
    dh = np.zeros(lv.shape[0])
    first = {}
    for i in np.nonzero(valid)[0]:
        v = int(lv[i])
        if v not in first:
            first[v] = i
        elif first[v] >= 0:
            dh[first[v]] += magnitude
            dh[i] -= magnitude
            first[v] = -1
    s.update_layer_costs(np.zeros_like(dh), dh)


def smooth_rates(label, host, objective, card, n):
    """ms per smooth iteration (torch ops) beside ms per MMA iteration
    (kernels) on one layout, and the kernels a hop of the smooth sweeps
    launches (profiler); the smooth iterations move no sweep kernel and no
    plain version."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bdd_tpu_torch.solver import smooth_mma as smma
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf

    sol = smma.SmoothSolver(host, objective, smoothing=0.2, smoothing_decay=1.0)
    geom = sol.geom
    smma.smooth_iterations(geom, sol.state, 1, 0.5, sol.smoothing)  # warm
    before, launched = plain_calls(), dict(sk.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = smma.smooth_iterations(geom, sol.state, n, 0.5, sol.smoothing)
    torch.cuda.synchronize()
    smooth_ms = 1e3 * (time.perf_counter() - t0) / n
    if plain_calls() != before or sweeps_of(sk.LAUNCHES) != sweeps_of(launched):
        fail(f"{label}: the smooth iterations called a plain version or a sweep kernel")
    hard = uf.init_uniform_state(host, objective)
    uf.iterations(geom, hard, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uf.iterations(geom, hard, n)
    torch.cuda.synchronize()
    mma_ms = 1e3 * (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        smma.smooth_iterations(geom, state, 1, 0.5, sol.smoothing)
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events() if e.name in ("cudaLaunchKernel", "cuLaunchKernel"))
    hops = 2 * sum(g.H for g in geom.buckets)
    print(f"[smooth] {label}: {smooth_ms:.4f} ms per smooth iteration (torch ops, {n} "
          f"iterations) vs {mma_ms:.4f} ms per MMA iteration (kernels) on the same layout "
          f"{[(g.P, g.H, g.B) for g in geom.buckets]}: {smooth_ms / mma_ms:.1f}x; "
          f"{kernels} kernel launches per smooth iteration = {kernels / hops:.1f} per hop "
          f"({hops} hops) {card}", flush=True)
    return smooth_ms, mma_ms


def phase_smooth(card, gm_python):
    """Phase 12: "smooth mma" through ``BddSolver`` on grid12 (float32 and
    float64, the float64 bound against the port's CPU run), the smooth bound
    at a fixed temperature, and the time of a smooth iteration beside an MMA
    iteration on grid12 and on gm50k's Python build."""
    from bdd_tpu_torch.api import BddSolver
    from bdd_tpu_torch.ilp import parse_lp_string
    from bdd_tpu_torch.solver import smooth_mma as smma
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.utils.problems import grid_mrf

    for prec in ("float", "double"):
        out = {}
        for device in ("cuda", "cpu") if prec == "double" else ("cuda",):
            sk.reset_launch_counts()
            before = plain_calls()
            cfg = {**SMOOTH_CFG, "precision": prec, **DUAL_ONLY, **fixed_iterations(SMOOTH_ITERS)}
            t0 = time.perf_counter()
            s = BddSolver(cfg, device=device).read_ilp(ilp=grid_mrf(12, 12, 4, seed=0))
            res = s.solve(verbose=False)
            wall = time.perf_counter() - t0
            if (res["status"] != "solved" or res["iterations"] != SMOOTH_ITERS
                    or not isinstance(s.solver, smma.SmoothSolver)):
                fail(f"smooth mma grid12 {prec} on {device}: {str(res)[:300]}")
            if device == "cuda" and (plain_calls() != before or any(sweeps_of(sk.LAUNCHES).values())
                                     or not sk.LAUNCHES[RUN]):
                fail(f"smooth mma grid12 {prec}: launches {dict(sk.LAUNCHES)}, plain versions "
                     f"{before} -> {plain_calls()}: the smooth sweeps run as torch ops and the "
                     f"hard bound through the run-only kernel entry")
            out[device] = res
            print(f"[smooth] grid12 {prec} on {device}: hard lb {res['lower_bound']!r} after "
                  f"{res['iterations']} iterations, final temperature {s.solver.smoothing}, "
                  f"smooth bound {s.solver.smooth_bound()!r}; solve {res['solve_time']} s = "
                  f"{1e3 * res['solve_time'] / res['iterations']:.4f} ms per iteration, "
                  f"{wall:.2f} s wall; launches {dict(sk.LAUNCHES)} {card}", flush=True)
        if prec == "double":
            a, b = out["cuda"]["lower_bound"], out["cpu"]["lower_bound"]
            if not abs(a - b) <= 1e-9 * abs(b):
                fail(f"smooth mma grid12 float64: card {a!r} vs CPU {b!r} (rel > 1e-9)")
            print(f"[smooth] grid12 float64: card and CPU bounds agree to rel 1e-9 ({a!r}, "
                  f"{b!r}) {card}", flush=True)
    # at a fixed temperature the hard bound of the costs lies at or above the
    # smooth bound after every iteration. The smooth bound ascends only
    # nearly: the relu-split of the deferred marginals is hard MMA's applied
    # to smoothed marginals (the reference comments its strict-monotonicity
    # asserts out). As the JAX package's test does: from a perturbed dual
    # point of MATCHING_3x3 at T = 0.5, no dip of more than 1e-3 relative and
    # an overall rise. On grid12 at T = 0.2 from the initial point the bound
    # rises for a few iterations and then falls towards its fixed point, as
    # the JAX package's does (the same trajectory; the CPU tests hold it):
    # reported, and the float64 trajectory on the card held to the CPU run.
    layouts = {}
    for label, make, T, perturb, n in (
            ("matching3x3", lambda: parse_lp_string(MATCHING_3X3), 0.5, True, 30),
            ("grid12", lambda: grid_mrf(12, 12, 4, seed=0), 0.2, False, SMOOTH_FIXED_T_ITERS)):
        for prec in ("float", "double"):
            runs = {}
            for device in ("cuda", "cpu") if prec == "double" else ("cuda",):
                s = BddSolver({"precision": prec, **DUAL_ONLY}, device=device).read_ilp(ilp=make())
                s.process_ilp().transform_to_bdds()
                sol = smma.SmoothSolver.from_collection(
                    s.pre.collection, s.pre.total_nr_variables(), s.pre.objective_vector(),
                    nr_primal_vars=s.pre.nr_primal_variables, dtype=s.dtype, device=device,
                    smoothing=T, smoothing_decay=1.0)
                if perturb:
                    perturb_zero_sum(sol)
                bounds, hards = [sol.smooth_bound()], [sol.lower_bound_with_deferred()]
                for _ in range(n):
                    sol.iteration()
                    bounds.append(sol.smooth_bound())
                    hards.append(sol.lower_bound_with_deferred())
                runs[device] = bounds, hards
                if device == "cuda" and label == "grid12":
                    layouts[prec] = (sol.host, s.pre.objective_vector())
            tol = 1e-9 if prec == "double" else 1e-4
            bounds, hards = runs["cuda"]
            dips = [b - a for a, b in zip(bounds, bounds[1:]) if b < a]
            deep = [b - a for a, b in zip(bounds, bounds[1:]) if b < a - 1e-3 * max(1.0, abs(a))]
            below = [i for i, (b, h) in enumerate(zip(bounds, hards)) if h < b - tol * abs(h)]
            if below or (perturb and (deep or not bounds[-1] > bounds[0] + 1e-3)):
                fail(f"smooth mma {label} {prec} at T = {T}: smooth bounds {bounds}, hard "
                     f"{hards}: dips {dips}, hard below smooth after iterations {below}")
            cpu = runs.get("cpu", ([], []))[0]
            if any(abs(a - b) > 1e-9 * abs(b) for a, b in zip(bounds, cpu)):
                fail(f"smooth mma {label} float64 at T = {T}: card {bounds} vs CPU {cpu}")
            peak = max(range(len(bounds)), key=lambda i: bounds[i])
            print(f"[smooth] {label} {prec} at T = {T}{', perturbed' if perturb else ''}, {n} "
                  f"iterations: smooth bound {bounds[0]!r} -> {bounds[-1]!r}, highest "
                  f"{bounds[peak]!r} after {peak}; {len(dips)} dips, the largest "
                  f"{min(dips, default=0.0):.3e}; hard bound {hards[-1]!r}, at or above the "
                  f"smooth one after every iteration"
                  f"{'; the trajectory equals the CPU run to rel 1e-9' if cpu else ''} {card}",
                  flush=True)
    for prec, (host, objective) in layouts.items():
        smooth_rates(f"grid12 {prec}", host, objective, card, 10)
    host, objective = gm_python[:2]
    sol = smma.SmoothSolver(host, objective, smoothing=0.2, smoothing_decay=0.5)
    before = plain_calls()
    t0 = time.perf_counter()
    sol.iteration_block(GM_SMOOTH_ITERS)
    lb = sol.lower_bound_with_deferred()
    wall = time.perf_counter() - t0
    if plain_calls() != before or not math.isfinite(lb):
        fail(f"smooth mma gm50k float32: lb {lb}, plain versions {before} -> {plain_calls()}")
    print(f"[smooth] gm50k float32 (Python build): hard lb {lb!r} after {GM_SMOOTH_ITERS} "
          f"smooth iterations at T = 0.2, smooth bound {sol.smooth_bound()!r} at T = "
          f"{sol.smoothing}; {wall:.2f} s wall {card}", flush=True)
    smooth_rates("gm50k float32", host, objective, card, 5)


def phase_python_pipeline(card, errs, times, flush):
    """Phase 7: BddPreprocessor -> flatten_uniform -> kernels, on grid12."""
    from bdd_tpu_torch.api import BddSolver
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf
    from bdd_tpu_torch.utils.problems import grid_mrf

    python = {"use native preprocessing": False}
    bounds = {}
    for label, extra in (("native", {}), ("python", python)):
        sk.reset_launch_counts()
        twins_before = plain_calls()
        t0 = time.perf_counter()
        s = BddSolver({"precision": "double", **DUAL_ONLY, **extra}, device="cuda").read_ilp(
            ilp=grid_mrf(12, 12, 4, seed=0))
        res = s.solve(verbose=False)
        bounds[label] = res["lower_bound"]
        counted = dict(sk.LAUNCHES)
        print(f"[python] grid12 float64 dual, {label} pipeline: lb {res['lower_bound']!r}, "
              f"{res['iterations']} iterations, launches {counted}, "
              f"{time.perf_counter() - t0:.2f} s wall {card}", flush=True)
        if sweeps_of(counted) != launch_counts(narrow=res["iterations"]):
            fail(f"grid12 float64, {label} pipeline: launches {counted} for "
                 f"{res['iterations']} iterations")
        if plain_calls() != twins_before:
            fail(f"grid12 float64, {label} pipeline: a plain sweep or run ran during the solve")
    path = {"at": "python grid12", "dt": "float64", "suffix": "", "launches": counted,
            "iterations": res["iterations"]}
    # the kernels against the twins on the layout flatten_uniform built, from
    # the state the solve left
    kernel_vs_twin(path["at"], s.solver.host, None, card, errs, times, flush,
                   state=s.solver.state)
    rel = abs(bounds["python"] - bounds["native"]) / abs(bounds["native"])
    if not rel <= 1e-7:
        fail(f"grid12 float64: python pipeline {bounds['python']!r} vs native "
             f"{bounds['native']!r} (rel {rel:.3e} > 1e-7)")
    for label, extra in (
        ("default float32 with rounding", {}),
        ("split chunk size 8", {"split chunk size": 8}),
        ("wedelin", {"rounding method": "wedelin"}),
        ("best", {"rounding method": "best"}),
    ):
        ilp = grid_mrf(12, 12, 4, seed=0)
        sk.reset_launch_counts()
        twins_before = plain_calls()
        t0 = time.perf_counter()
        s = BddSolver({**python, **extra}, device="cuda").read_ilp(ilp=ilp)
        res = s.solve(verbose=False)
        wall = time.perf_counter() - t0
        checked_solution(ilp, res, f"python pipeline, {label}")
        counted = dict(sk.LAUNCHES)
        if (min(counted[k] for k in KERNELS) < res["iterations"]
                or plain_calls() != twins_before):
            fail(f"python pipeline, {label}: launches {counted} for {res['iterations']} "
                 f"dual iterations, plain versions {plain_calls()} from {twins_before}")
        print(f"[python] grid12 {label}: lb {res['lower_bound']!r}, objective "
              f"{res['objective']!r}, {res['iterations']} dual iterations, launches {counted}, "
              f"buckets {[(g.P, g.H, g.B) for g in s.solver.geom.buckets]}, {wall:.2f} s wall "
              f"{card}", flush=True)
        if "split" in label:  # the split layout: other bucket shapes than above
            kernel_vs_twin("python grid12 split", s.solver.host, None, card, errs, times, flush,
                           state=s.solver.state)
    return path


def phase_batch(card, errs, times, flush):
    """Phase 8: solve_batch over independent-set instances."""
    from bdd_tpu_torch.api import BddSolver
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf
    from bdd_tpu_torch.utils.problems import independent_set

    def instances(K):
        return [independent_set(100, edge_prob=0.08, seed=s) for s in range(K)]

    base = fixed_iterations(BATCH_ITERS)
    alone, alone_wall, alone_solve = [], 0.0, 0.0
    for ilp in instances(8):
        t0 = time.perf_counter()
        res = BddSolver({**base, **DUAL_ONLY}, device="cuda").read_ilp(ilp=ilp).solve(
            verbose=False)
        alone_wall += time.perf_counter() - t0
        alone_solve += res["solve_time"]
        alone.append(res["lower_bound"])
    print(f"[batch] one by one, 8 instances, {BATCH_ITERS} iterations each, rounding off: "
          f"{alone_wall:.2f} s wall ({8 * BATCH_ITERS / alone_wall:.1f} instance-iterations/s), "
          f"of it dual solve {alone_solve:.2f} s ({8 * BATCH_ITERS / alone_solve:.1f}) {card}",
          flush=True)
    paths = []
    for K in (64, 256):
        for rounding in (False, True):
            ilps = instances(K)
            cfg = dict(base) if rounding else {**base, **DUAL_ONLY}
            s = BddSolver(cfg, device="cuda")
            sk.reset_launch_counts()
            twins_before = plain_calls()
            t0 = time.perf_counter()
            results = s.solve_batch(ilps=ilps, verbose=False)
            wall = time.perf_counter() - t0
            solve_s = s.dual_stats["solve_time"]
            if s.dual_stats["iterations"] != BATCH_ITERS:
                fail(f"batch of {K}: {s.dual_stats['iterations']} iterations")
            if len(results) != K or any(r["status"] != "solved" for r in results):
                fail(f"batch of {K}: {[r['status'] for r in results if r['status'] != 'solved'][:4]}")
            for k in range(4):
                got, want = results[k]["lower_bound"], alone[k]
                if abs(got - want) > 2e-5 * abs(want) + 2e-4:
                    fail(f"batch of {K}, instance {k}: bound {got!r} vs alone {want!r}")
            shape = [(g.P, g.H, g.B) for g in s.solver.geom.buckets]
            if plain_calls() != twins_before:
                fail(f"batch of {K}: a plain sweep or run ran during the batched solve")
            if not rounding:
                if sweeps_of(sk.LAUNCHES) != launch_counts(narrow=BATCH_ITERS):
                    fail(f"batch of {K}: launches {sk.LAUNCHES}; expected "
                         f"{launch_counts(narrow=BATCH_ITERS)}")
                paths.append({"at": f"batch{K}", "dt": "float32", "suffix": "",
                              "launches": dict(sk.LAUNCHES), "iterations": BATCH_ITERS})
                print(f"[batch] K={K} rounding off: {s.solver.host.nr_bdds} BDDs in buckets "
                      f"{shape}; {wall:.2f} s wall, build {wall - solve_s:.2f} s, dual solve "
                      f"{solve_s:.3f} s = {K * BATCH_ITERS / solve_s:.1f} instance-iterations/s "
                      f"({K * BATCH_ITERS / wall:.1f} with the build); launches "
                      f"{dict(sk.LAUNCHES)}; bounds of 4 instances equal those solved alone "
                      f"{card}", flush=True)
                # the kernels against the twins on the batch's own layout and state
                kernel_vs_twin(f"batch{K}", s.solver.host, None, card, errs, times, flush,
                               state=s.solver.state)
            else:
                for k, (ilp, r) in enumerate(zip(ilps, results)):
                    checked_solution(ilp, r, f"batch of {K}, instance {k}")
                print(f"[batch] K={K} rounding on: {wall:.2f} s wall, dual solve {solve_s:.3f} s; "
                      f"all {K} solutions feasible for their own ILP; launches "
                      f"{dict(sk.LAUNCHES)} {card}", flush=True)
    return paths


def phase_serve(card, gm_lp, gm_bound, errs, times, flush):
    """Phase 9: the JSONL server, in process and as a process of its own."""
    import io
    import tempfile

    from bdd_tpu_torch.api import BddSolver
    from bdd_tpu_torch.serve import serve
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf
    from bdd_tpu_torch.utils.problems import grid_mrf, independent_set

    grid_cfg = {"relaxation solver": "uniform mma", "variable order": "bfs",
                "termination criteria": {"maximum iterations": 1000}}
    with tempfile.TemporaryDirectory() as td:
        def write(name, text):
            path = os.path.join(td, name)
            with open(path, "w") as fh:
                fh.write(text)
            return path

        grids = [write(f"g{seed}.lp", grid_mrf(12, 12, 4, seed=seed).write_lp()) for seed in (0, 7)]
        gm = write("gm50k.lp", gm_lp)
        mis = [write(f"mis{s}.lp", independent_set(100, edge_prob=0.08, seed=s).write_lp())
               for s in range(8)]
        requests = [
            json.dumps({**grid_cfg, "input": grids[0]}),
            json.dumps({**grid_cfg, "input": grids[1]}),
            json.dumps({"input": gm, "variable order": "bfs", **DUAL_ONLY,
                        **fixed_iterations(GM_ITERS)}),
            json.dumps({"inputs": mis, **fixed_iterations(BATCH_ITERS)}),
            "this is not json",
            json.dumps({"input": os.path.join(td, "missing.lp")}),
            json.dumps({"shutdown": True}),
            json.dumps({**grid_cfg, "input": grids[0]}),  # after shutdown: not served
        ]
        # the server pulls a line when the request before it is answered, so
        # the counters read at each pull bracket every request
        marks = []

        def pulled():
            for line in requests:
                marks.append((dict(sk.LAUNCHES), plain_calls()))
                yield line

        out = io.StringIO()
        sk.reset_launch_counts()
        served = serve(pulled(), out, device="cuda")
        lines = [json.loads(line) for line in out.getvalue().splitlines()]
        if served != 6 or len(lines) != 7 or len(marks) != 7:
            fail(f"server: served {served} requests, wrote {len(lines)} lines and pulled "
                 f"{len(marks)}; expected 6, 7, 7")
        g0, g7, gmr, batch, bad_json, missing, bye = lines
        counted = [{k: after[0][k] - before[0][k] for k in before[0]}
                   for before, after in zip(marks, marks[1:])]
        if marks[-1][1] != marks[0][1]:
            fail(f"server: plain sweeps or runs on the card: {marks[0][1]} -> {marks[-1][1]}")
        for what, r in (("grid12 seed 0", g0), ("grid12 seed 7", g7), ("gm50k", gmr)):
            if not isinstance(r, dict) or r.get("status") != "solved":
                fail(f"server: good request {what} answered {str(r)[:300]}")
        if "solution" not in g0 or "solution" not in g7:
            fail("server: a grid12 request came back without a solution")
        if gmr["lower_bound"] != gm_bound:
            fail(f"server: gm50k bound {gmr['lower_bound']!r} vs the direct solve {gm_bound!r}")
        if sweeps_of(counted[2]) != launch_counts(narrow=GM_ITERS):
            fail(f"server: the gm50k request launched {counted[2]}; expected "
                 f"{launch_counts(narrow=GM_ITERS)}")
        for what, r, c in (("grid12 seed 0", g0, counted[0]), ("grid12 seed 7", g7, counted[1])):
            if (min(c[k] for k in KERNELS) < r["iterations"]
                    or sweeps_of(c) != launch_counts(c[KERNELS[0]])):
                fail(f"server: {what} launched {c} for {r['iterations']} dual iterations")
        if (min(counted[3][k] for k in KERNELS) < BATCH_ITERS
                or any(counted[3][k + WIDE] for k in KERNELS)):
            fail(f"server: the batch request launched {counted[3]}")
        if any(any(c.values()) for c in counted[4:]):
            fail(f"server: the bad requests and shutdown launched {counted[4:]}")
        if (not isinstance(batch, list) or len(batch) != 8
                or any(r.get("status") != "solved" or "solution" not in r for r in batch)):
            fail(f"server: batch request answered {str(batch)[:300]}")
        if bad_json.get("status") != "error" or "bad json" not in bad_json.get("message", ""):
            fail(f"server: the line that is no JSON answered {bad_json}")
        if missing.get("status") != "error" or bye != {"status": "bye"}:
            fail(f"server: missing file answered {missing}, shutdown {bye}")
        print(f"[serve] in process (warm from the phases before): grid12 seed 0 {g0['wall_s']} s, "
              f"seed 7 {g7['wall_s']} s (lb {g7['lower_bound']!r}, objective {g7['objective']!r}); "
              f"gm50k {GM_ITERS} iterations {gmr['wall_s']} s, lb {gmr['lower_bound']!r} equal "
              f"to the direct solve's; batch of 8: all solved; bad JSON and missing file "
              f"answered 'error'; 'bye' ended the loop; launches per request {counted[:4]}, no "
              f"twin sweep {card}", flush=True)
        # the layouts the server swept are gm50k's and grid12's of phase 2
        # (same text, same order, the native host) and the batch request's,
        # built here as handle_request builds it: kernels against twins on it
        s = BddSolver(json.loads(requests[3]), device="cuda")
        s.solve_batch(paths=mis, verbose=False)
        kernel_vs_twin("serve batch8", s.solver.host, None, card, errs, times, flush,
                       state=s.solver.state)
        path = {"at": "serve batch8", "dt": "float32", "suffix": "", "launches": counted[3],
                "iterations": None}
        # the same server as a process of its own: its first request pays the
        # CUDA context and the load of both libraries (built above), its second
        # finds them warm
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "bdd_tpu_torch.serve", "--device", "cuda"],
            input="\n".join(requests[:2] + requests[6:7]) + "\n", capture_output=True,
            text=True, timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        total = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"server process exited {proc.returncode}: {proc.stderr[-500:]}")
        cold, warm, bye = (json.loads(line) for line in proc.stdout.splitlines())
        if cold.get("status") != "solved" or warm.get("status") != "solved" or bye != {"status": "bye"}:
            fail(f"server process answered {proc.stdout[:500]}")
        print(f"[serve] own process: grid12 seed 0 cold {cold['wall_s']} s, seed 7 warm "
              f"{warm['wall_s']} s, process start to exit {total:.2f} s {card}", flush=True)
    return path


def phase_outer(card, gm_lp, gm_host, gm_objective, errs, times, flush):
    """Phase 10: the outer loops (L-BFGS, subgradient) over the kernels."""
    import torch
    from bdd_tpu_torch.api import BddSolver
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf
    from bdd_tpu_torch.solver.lbfgs import LbfgsSolver
    from bdd_tpu_torch.solver.subgradient import SubgradientSolver
    from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver
    from bdd_tpu_torch.utils.problems import grid_mrf

    def solve(what, cfg, ilp=None, lp=None):
        """One solve through the user entry point, its launches and wall time;
        fails if a plain sweep or plain run touched a CUDA tensor."""
        sk.reset_launch_counts()
        before = plain_calls()
        t0 = time.perf_counter()
        s = BddSolver(cfg, device="cuda").read_ilp(ilp=ilp, lp_string=lp)
        res = s.solve(verbose=False)
        wall = time.perf_counter() - t0
        counted = dict(sk.LAUNCHES)
        if res.get("status") != "solved" or not math.isfinite(res["lower_bound"]):
            fail(f"{what}: {str(res)[:200]}")
        if plain_calls() != before:
            fail(f"{what}: plain versions ran on the card: {before} -> {plain_calls()}")
        n = res["iterations"]
        print(f"[outer] {what}: lb {res['lower_bound']!r} after {n} iterations, solve "
              f"{res['solve_time']} s = {1e3 * res['solve_time'] / n:.4f} ms per iteration, "
              f"{wall:.2f} s wall; launches {counted}, per iteration "
              f"{ {k: round(v / n, 3) for k, v in counted.items() if v} }; no plain sweep, no "
              f"plain run {card}", flush=True)
        return s, res, counted

    python = {"use native preprocessing": False}
    paths = []
    # ---- grid12, float64: L-BFGS with rounding (twice), subgradient, plain MMA
    grid = {"precision": "double", **python, **fixed_iterations(GRID_OUTER_ITERS)}
    lbfgs_cfg = {**grid, "relaxation solver": "lbfgs parallel mma"}
    ilp = grid_mrf(12, 12, 4, seed=0)
    s, res, counted = solve("grid12 float64 lbfgs parallel mma, rounding on", lbfgs_cfg, ilp=ilp)
    if not isinstance(s.solver, LbfgsSolver) or not isinstance(s.solver.base, UniformSolver):
        fail(f"grid12 lbfgs: the solver is {type(s.solver).__name__}")
    checked_solution(ilp, res, "grid12 lbfgs")
    _, again, _ = solve("grid12 float64 lbfgs parallel mma, rerun", lbfgs_cfg,
                        ilp=grid_mrf(12, 12, 4, seed=0))
    if (again["lower_bound"], again["objective"]) != (res["lower_bound"], res["objective"]):
        fail(f"grid12 lbfgs: two runs gave {res['lower_bound']!r}, {res['objective']!r} and "
             f"{again['lower_bound']!r}, {again['objective']!r}")
    sd, dual, dual_counted = solve("grid12 float64 lbfgs parallel mma, dual only",
                                   {**lbfgs_cfg, **DUAL_ONLY}, ilp=grid_mrf(12, 12, 4, seed=0))
    _, mma, _ = solve("grid12 float64 uniform mma, dual only", {**grid, **DUAL_ONLY},
                      ilp=grid_mrf(12, 12, 4, seed=0))
    ss, sub, _ = solve("grid12 float64 subgradient, dual only",
                       {**grid, **DUAL_ONLY, "relaxation solver": "subgradient"},
                       ilp=grid_mrf(12, 12, 4, seed=0))
    _, sub2, _ = solve("grid12 float64 subgradient, rerun",
                       {**grid, **DUAL_ONLY, "relaxation solver": "subgradient"},
                       ilp=grid_mrf(12, 12, 4, seed=0))
    if not isinstance(ss.solver, SubgradientSolver):
        fail(f"grid12 subgradient: the solver is {type(ss.solver).__name__}")
    floor = mma["lower_bound"] - 1e-3 * abs(mma["lower_bound"])
    if dual["iterations"] != mma["iterations"] or not dual["lower_bound"] >= floor:
        fail(f"grid12 lbfgs bound {dual['lower_bound']!r} after {dual['iterations']} iterations "
             f"vs plain MMA {mma['lower_bound']!r} after {mma['iterations']}")
    # subgradient ascent takes no MMA iteration: it is held to the primal
    # objective and to its own rerun, not to MMA's bound (the CPU tests hold
    # its trajectory to the JAX package's)
    if (sub["lower_bound"] != sub2["lower_bound"]
            or not sub["lower_bound"] <= res["objective"] + 1e-6):
        fail(f"grid12 subgradient: bound {sub['lower_bound']!r} (rerun {sub2['lower_bound']!r}) "
             f"from {sub['initial_lower_bound']!r}, objective {res['objective']!r}")
    print(f"[outer] grid12 float64 after {GRID_OUTER_ITERS} iterations: lbfgs "
          f"{dual['lower_bound']!r} >= plain MMA {mma['lower_bound']!r} - 1e-3 rel (difference "
          f"{dual['lower_bound'] - mma['lower_bound']:.3e}); with rounding lb "
          f"{res['lower_bound']!r}, objective {res['objective']!r}, two runs identical; "
          f"subgradient {sub['lower_bound']!r} from {sub['initial_lower_bound']!r}, two runs "
          f"identical; ms per iteration: lbfgs {1e3 * dual['solve_time'] / dual['iterations']:.4f}, "
          f"MMA {1e3 * mma['solve_time'] / mma['iterations']:.4f}, subgradient "
          f"{1e3 * sub['solve_time'] / sub['iterations']:.4f} {card}", flush=True)
    kernel_vs_twin("grid12 lbfgs", sd.solver.base.host, None, card, errs, times, flush,
                   state=sd.solver.base.state)
    paths.append({"at": "grid12 lbfgs", "dt": "float64", "suffix": "", "launches": dual_counted,
                  "iterations": dual["iterations"]})
    # ---- gm50k, float32: L-BFGS dual only, a fixed number of outer iterations
    gm = {"variable order": "bfs", **DUAL_ONLY, **python, **fixed_iterations(GM_OUTER_ITERS)}
    gm_lbfgs = {**gm, "relaxation solver": "lbfgs parallel mma"}
    s, res, counted = solve("gm50k float32 lbfgs parallel mma", gm_lbfgs, lp=gm_lp)
    # the rerun and plain MMA on the layout that solve built (the Python
    # pipeline takes far longer to build gm50k than to solve it), through the
    # same termination loop
    from bdd_tpu_torch.solver.run import run_solver

    def rerun(what, wrap):
        sk.reset_launch_counts()
        before = plain_calls()
        solver = wrap(UniformSolver(s.solver.base.host, s.pre.objective_vector()))
        stats = {}
        t = gm["termination criteria"]
        run_solver(solver, max_iter=t["maximum iterations"], tolerance=0.0, improvement_slope=0.0,
                   time_limit=3600, verbose=False, block_size=solver.default_block_size,
                   stats=stats)
        stats["lower_bound"] = float(solver.lower_bound_with_deferred())
        if plain_calls() != before:
            fail(f"{what}: plain versions ran on the card: {before} -> {plain_calls()}")
        print(f"[outer] {what}: lb {stats['lower_bound']!r} after {stats['iterations']} "
              f"iterations, solve {stats['solve_time']} s; launches {dict(sk.LAUNCHES)} {card}",
              flush=True)
        return stats

    again = rerun("gm50k float32 lbfgs, rerun on the same layout", LbfgsSolver)
    mma = rerun("gm50k float32 plain MMA on the same layout", lambda base: base)
    if again["lower_bound"] != res["lower_bound"]:
        fail(f"gm50k lbfgs: two runs gave {res['lower_bound']!r} and {again['lower_bound']!r}")
    floor = mma["lower_bound"] - 1e-3 * abs(mma["lower_bound"])
    if res["iterations"] != mma["iterations"] or not res["lower_bound"] >= floor:
        fail(f"gm50k lbfgs bound {res['lower_bound']!r} after {res['iterations']} iterations vs "
             f"plain MMA {mma['lower_bound']!r} after {mma['iterations']}")
    outer = s.solver
    print(f"[outer] gm50k float32 after {GM_OUTER_ITERS} iterations: lbfgs {res['lower_bound']!r} "
          f">= plain MMA {mma['lower_bound']!r} - 1e-3 rel (difference "
          f"{res['lower_bound'] - mma['lower_bound']:.3e}), two runs identical; history "
          f"{len(outer.history)} of {outer.m}, step size {outer.step_size:.3e}, failed searches "
          f"{outer.num_unsuccessful}; ms per iteration: lbfgs "
          f"{1e3 * res['solve_time'] / res['iterations']:.4f}, MMA "
          f"{1e3 * mma['solve_time'] / mma['iterations']:.4f}; buckets "
          f"{[(g.P, g.H, g.B) for g in outer.base.geom.buckets]} {card}", flush=True)
    kernel_vs_twin("gm50k lbfgs", outer.base.host, None, card, errs, times, flush,
                   state=outer.base.state)
    gm_python = (outer.base.host, s.pre.objective_vector(), s.pre, s.flat)
    paths.append({"at": "gm50k lbfgs", "dt": "float32", "suffix": "", "launches": counted,
                  "iterations": res["iterations"]})
    # ---- what an outer iteration is made of, on the native gm50k layout: the
    # hop loops that are still torch ops beside the run-only entry
    sol = UniformSolver(gm_host, gm_objective)
    sol.iteration_block(5)
    geom, st = sol.geom, sol.state
    g0 = geom.buckets[0]
    parts = {
        "bdds_solution": cuda_ms(lambda: uf.bdds_solution(geom, st), 3),
        "bucket_forward_run (bucket 0)": cuda_ms(
            lambda: uf.bucket_forward_run(g0, st.lo[0], st.hi[0]), 3),
        "min_marginals_all": cuda_ms(lambda: uf.min_marginals_all(geom, st), 3),
        "backward_run (kernel)": cuda_ms(lambda: uf.backward_run(geom, st.flat[0], st.flat[1]), 50),
        "net_solver_costs": cuda_ms(lambda: uf.net_solver_costs(geom, st), 20),
        "make_dual_feasible": cuda_ms(lambda: uf.make_dual_feasible(geom, st.flat[1]), 20),
        "gradient_step": cuda_ms(lambda: uf.gradient_step(geom, st, st.flat[1], 1e-6), 20),
        "iteration (MMA)": cuda_ms(lambda: uf.iteration(geom, st), 50),
    }
    print(f"[outer] gm50k float32 native layout {[(g.P, g.H, g.B) for g in geom.buckets]}, ms per "
          f"call on the card: { {k: round(v, 4) for k, v in parts.items()} } {card}", flush=True)
    return paths, gm_python


HYBRID_ITERS = 200
GM_HYBRID_ITERS = 100
UNSPLIT_ITERS = 50


def hybrid_instance():
    """The JAX package's own hybrid instance (benchmarks/hybrid_solver.py:39-45):
    set cover, 500 rows over 2,000 sets, and one row over all 2,000 sets
    (a BDD 2,000 levels deep, some 300 nodes wide)."""
    from bdd_tpu_torch.ilp.model import Ineq
    from bdd_tpu_torch.utils.problems import set_cover

    ilp = set_cover(500, 2000, density=0.004, seed=0)
    ilp.add_linear_constraint([1] * 2000, list(range(2000)), Ineq.LEQ, 300)
    ilp.reorder_bfs()
    ilp.normalize()
    return ilp


class TimedHost:
    """A hybrid's host solver with the time of every half-sweep recorded (on
    the worker thread that runs it); every other call passes through."""

    def __init__(self, cs):
        self._cs = cs
        self.seconds = []

    def half_iteration_ext(self, *args):
        t0 = time.perf_counter()
        self._cs.half_iteration_ext(*args)
        self.seconds.append(time.perf_counter() - t0)

    def __getattr__(self, name):
        return getattr(self._cs, name)


def host_half_sweep_ms(hs, collection, objective, n=20) -> float:
    """ms of one host half-sweep alone: a native solver over the hybrid's
    host BDDs with the global counts, nothing else running."""
    import numpy as np
    from bdd_tpu_torch import native
    from bdd_tpu_torch.solver.hybrid import _subset_flat

    cs = native.cpu_solver_from_flat(*_subset_flat(collection, hs.host_bdds), hs.nr_vars,
                                     objective, nbpv=hs.f.num_bdds_per_var)
    delta = np.zeros((hs.nr_vars, 2))
    cs.half_iteration_ext(0.5, 1, delta)  # warm
    t0 = time.perf_counter()
    for k in range(n):
        cs.half_iteration_ext(0.5, 1 if k % 2 == 0 else -1, delta)
    return 1e3 * (time.perf_counter() - t0) / n


def consensus_steps(label, hs, card, n=10) -> None:
    """ms of each host step of one consensus, alone (the solver idle): the
    device sums [V + 1, 2] read to the host, the host solver's partial
    delta, the float64 combination, and the host share cast, copied up and
    added on the card."""
    import numpy as np
    import torch

    V = hs.nr_vars
    dsum = torch.zeros((V + 1, 2), dtype=hs.dtype, device="cuda")
    cpu_d = np.zeros((V, 2))
    torch.cuda.synchronize()

    def ms(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    def add():
        hs._contrib[:V] = torch.from_numpy(cpu_d)
        return dsum + hs._contrib.to(dsum.device, non_blocking=True)

    part = dsum.cpu()
    steps = {"read [V + 1, 2]": ms(dsum.cpu), "partial_delta": ms(hs._cs.partial_delta),
             "combine": ms(lambda: part[:V].to(torch.float64).numpy() + cpu_d),
             "cast, copy up, add": ms(add)}
    print(f"[hybrid] {label}: one consensus, each host step alone (V = {V}): "
          f"{ {k: round(v, 4) for k, v in steps.items()} } ms {card}", flush=True)


def hybrid_syncs(label, hs, card, n=10) -> float:
    """Host syncs per iteration of a hybrid block under torch.profiler,
    between its first and last kernel launch (one per consensus is the
    design: two an iteration)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        hs.iteration_block(n)
        torch.cuda.synchronize()
    events = list(prof.events())
    launches = [e.time_range.start for e in events
                if e.name in ("cudaLaunchKernel", "cuLaunchKernel")]
    if not launches:
        fail(f"hybrid {label}: the profiler saw no kernel launch")
    first, last = min(launches), max(launches)
    syncs = {}
    for e in events:
        if e.name in SYNC_EVENTS and first <= e.time_range.start <= last:
            syncs[e.name] = syncs.get(e.name, 0) + 1
    per = sum(syncs.values()) / n
    print(f"[hybrid] {label}: host syncs in a block of {n} iterations {syncs}: {per:.2f} per "
          f"iteration {card}", flush=True)
    return per


def run_hybrid(label, hs, n, card):
    """n iterations of a hybrid in blocks of 25 with its host half-sweeps
    timed; fails if a plain version ran. Returns (ms per iteration, bound,
    launches, host half-sweep ms inside the hybrid)."""
    import torch
    from bdd_tpu_torch.solver import sweep_kernels as sk

    timed_host = hs._cs = TimedHost(hs._cs)
    sk.reset_launch_counts()
    before = plain_calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(0, n, 25):
        hs.iteration_block(min(25, n - k))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / n
    lb = hs.lower_bound_with_deferred()  # one launch of the run-only entry
    counted = dict(sk.LAUNCHES)
    if plain_calls() != before:
        fail(f"{label}: plain versions ran on the card: {before} -> {plain_calls()}")
    inside = 1e3 * sum(timed_host.seconds) / max(1, len(timed_host.seconds))
    if len(timed_host.seconds) != 2 * n:
        fail(f"{label}: {len(timed_host.seconds)} host half-sweeps in {n} iterations")
    hs._cs = timed_host._cs
    return ms, lb, counted, inside


def phase_hybrid(card, errs, times, flush, gm_python, gm_nh, gm_f32, gm_bound):
    """Phase 13: the hybrid CPU + GPU solve (``solver/hybrid.py``): the deep
    BDDs on the native solver's worker thread, the rest through the sweep
    kernels, the delta summed across both every half-sweep; then the
    extras on the card (float64 transfer, checkpoints)."""
    import tempfile
    import threading

    import torch
    from bdd_tpu_torch import native
    from bdd_tpu_torch.api import BddSolver
    from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor
    from bdd_tpu_torch.solver import extras
    from bdd_tpu_torch.solver import layout
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver.hybrid import HybridSolver
    from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver
    from bdd_tpu_torch.utils.problems import grid_mrf

    threads_before = threading.active_count()
    paths = []
    # ---- (a) the JAX package's hybrid instance, automatic threshold
    t0 = time.perf_counter()
    pre = BddPreprocessor(hybrid_instance())
    col, V, obj = pre.collection, pre.total_nr_variables(), pre.objective_vector()
    depths = [len(col.level_variables(b)) for b in range(col.nr_bdds())]
    print(f"[hybrid] set cover 500 x 2,000 + one row over all: {col.nr_bdds()} BDDs, "
          f"{len(col.var)} nodes, depths {max(depths)} (deepest) and {sorted(depths)[-2]} (next); "
          f"Python build {time.perf_counter() - t0:.2f} s {card}", flush=True)
    whole = native.cpu_solver_from_collection(col, V, obj)
    t0 = time.perf_counter()
    whole.iterations(HYBRID_ITERS, 0.5)
    native_ms = 1e3 * (time.perf_counter() - t0) / HYBRID_ITERS
    lb_native = whole.lower_bound_with_deferred()
    rates = {}
    for name, dtype, prec in (("float32", torch.float32, "float"),
                              ("float64", torch.float64, "double")):
        t0 = time.perf_counter()
        hs = HybridSolver(col, V, obj, nr_primal_vars=pre.nr_primal_variables, dtype=dtype,
                          device="cuda")
        build_s = time.perf_counter() - t0
        if len(hs.host_bdds) != 1 or depths[hs.host_bdds[0]] != max(depths):
            fail(f"hybrid deep {name}: threshold {hs.hop_threshold} put BDDs {hs.host_bdds[:5]} "
                 f"on the host; expected the deepest alone")
        ms, lb, counted, inside = run_hybrid(f"hybrid deep {name}", hs, HYBRID_ITERS, card)
        rel = abs(lb - lb_native) / abs(lb_native)
        per_it = {k: v / HYBRID_ITERS for k, v in counted.items() if v}
        print(f"[hybrid] deep {name}: {len(hs.host_bdds)} BDD on the host, "
              f"{len(hs.device_bdds)} on the card in buckets "
              f"{[(g.P, g.H, g.B) for g in hs.geom.buckets]} (threshold {hs.hop_threshold}, "
              f"layout {build_s:.2f} s); lb {lb!r} after {HYBRID_ITERS} iterations vs the native "
              f"solver over the whole collection {lb_native!r}: rel {rel:.3e} (limit "
              f"{LB_REL[prec]}); {ms:.4f} ms per iteration = {1e3 / ms:.1f} it/s (native whole "
              f"{native_ms:.4f} ms = {1e3 / native_ms:.1f} it/s, {whole.nr_threads()} threads); "
              f"host half-sweep inside the hybrid {inside:.4f} ms; launches per iteration "
              f"{per_it} {card}", flush=True)
        if not rel <= LB_REL[prec]:
            fail(f"hybrid deep {name}: bound off the native solver over the whole collection")
        if sweeps_of(counted) != launch_counts(narrow=HYBRID_ITERS):
            fail(f"hybrid deep {name}: launches {counted}; expected one narrow launch per "
                 f"kernel and iteration")
        syncs = hybrid_syncs(f"deep {name}", hs, card)
        consensus_steps(f"deep {name}", hs, card)
        alone = host_half_sweep_ms(hs, col, obj)
        dev = UniformSolver(hs.host, obj)  # the device share alone, no consensus
        dev.iteration_block(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev.iteration_block(HYBRID_ITERS)
        torch.cuda.synchronize()
        dev_ms = 1e3 * (time.perf_counter() - t0) / HYBRID_ITERS
        print(f"[hybrid] deep {name}: host half-sweep alone {alone:.4f} ms vs {inside:.4f} ms "
              f"inside the hybrid; the card's share alone (no consensus) {dev_ms:.4f} ms per "
              f"iteration; the hybrid {ms:.4f} ms {card}", flush=True)
        if syncs != 2:
            fail(f"hybrid deep {name}: {syncs} host syncs per iteration; expected 2")
        rates[name] = 1e3 / ms
        kernel_vs_twin("hybrid deep", hs.host, None, card, errs, times, flush, state=hs.state)
        paths.append({"at": "hybrid deep", "dt": name, "suffix": "", "launches": counted,
                      "iterations": HYBRID_ITERS})
        if name == "float64":
            card_lb, hs_lb = lb, hs.lower_bound_with_deferred()
            full = hs.to_native_full()
            full_lb = full.lower_bound_with_deferred()
            hs.iteration_block(10)
            full.iterations(10, 0.5)
            cont = (hs.lower_bound_with_deferred(), full.lower_bound_with_deferred())
            print(f"[hybrid] deep float64 to_native_full: bound {full_lb!r} vs the hybrid's "
                  f"{hs_lb!r}; 10 iterations on: native {cont[1]!r}, hybrid {cont[0]!r} {card}",
                  flush=True)
            if not (abs(full_lb - hs_lb) <= 1e-7 * abs(hs_lb)
                    and abs(cont[1] - cont[0]) <= 1e-7 * abs(cont[0])):
                fail("hybrid deep float64: to_native_full does not continue the trajectory")
        hs.close()
        del hs
    cpu = HybridSolver(col, V, obj, nr_primal_vars=pre.nr_primal_variables,
                       dtype=torch.float64, device="cpu")
    t0 = time.perf_counter()
    cpu.iteration_block(HYBRID_ITERS)
    cpu_lb = cpu.lower_bound_with_deferred()
    cpu_s = time.perf_counter() - t0
    cpu.close()
    if not abs(cpu_lb - card_lb) <= 1e-9 * abs(cpu_lb):
        fail(f"hybrid deep float64: card {card_lb!r} vs CPU {cpu_lb!r} (rel > 1e-9)")
    print(f"[hybrid] deep float64: card and CPU bounds agree to rel 1e-9 ({card_lb!r}, "
          f"{cpu_lb!r}; the CPU run {cpu_s:.2f} s) {card}", flush=True)
    # the card alone, the deep BDD unsplit in the layout (a wide bucket of
    # 2,000 hops)
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        host = layout.flatten_uniform(col, V, pre.nr_primal_variables, dtype=dtype,
                                      device="cuda")
        sol = UniformSolver(host, obj)
        sol.iteration_block(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol.iteration_block(UNSPLIT_ITERS)
        torch.cuda.synchronize()
        unsplit_ms = 1e3 * (time.perf_counter() - t0) / UNSPLIT_ITERS
        print(f"[hybrid] deep {name}, the card alone with the deep BDD unsplit: buckets "
              f"{[(g.P, g.H, g.B) for g in host.geom.buckets]}, {unsplit_ms:.4f} ms per "
              f"iteration = {1e3 / unsplit_ms:.1f} it/s vs the hybrid's {rates[name]:.1f} "
              f"{card}", flush=True)
        del sol, host

    # ---- (b) gm50k float32 on phase 10's Python build, every 50th BDD on the host
    gm_host, _, gm_pre = gm_python[:3]
    col, V, obj = gm_pre.collection, gm_pre.total_nr_variables(), gm_pre.objective_vector()
    t0 = time.perf_counter()
    hs = HybridSolver(col, V, obj, nr_primal_vars=gm_pre.nr_primal_variables,
                      dtype=torch.float32, device="cuda",
                      force_host_bdds=range(0, col.nr_bdds(), 50))
    build_s = time.perf_counter() - t0
    ms, lb, counted, inside = run_hybrid("hybrid gm50k", hs, GM_HYBRID_ITERS, card)
    whole = native.cpu_solver_from_collection(col, V, obj)
    whole.iterations(GM_HYBRID_ITERS, 0.5)
    lb_native = whole.lower_bound_with_deferred()
    rel = abs(lb - lb_native) / abs(lb_native)
    full = UniformSolver(gm_host, obj)  # phase 10's layout of the whole collection
    full.iteration_block(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full.iteration_block(GM_HYBRID_ITERS)
    torch.cuda.synchronize()
    mma_ms = 1e3 * (time.perf_counter() - t0) / GM_HYBRID_ITERS
    del full
    alone = host_half_sweep_ms(hs, col, obj)
    print(f"[hybrid] gm50k float32: {len(hs.host_bdds)} BDDs on the host, {len(hs.device_bdds)} "
          f"on the card (layout {build_s:.2f} s); lb {lb!r} after {GM_HYBRID_ITERS} iterations vs "
          f"the native solver over the whole collection {lb_native!r}: rel {rel:.3e} (limit "
          f"{LB_REL['float']}); {ms:.4f} ms per iteration vs plain MMA on the full layout "
          f"{mma_ms:.4f} ms; host half-sweep alone {alone:.4f} ms, inside {inside:.4f} ms; "
          f"launches per iteration "
          f"{ {k: v / GM_HYBRID_ITERS for k, v in counted.items() if v} } {card}", flush=True)
    if not rel <= LB_REL["float"]:
        fail("hybrid gm50k float32: bound off the native solver over the whole collection")
    if sweeps_of(counted) != launch_counts(narrow=GM_HYBRID_ITERS):
        fail(f"hybrid gm50k: launches {counted}; expected one narrow launch per kernel and "
             f"iteration")
    if hybrid_syncs("gm50k float32", hs, card) != 2:
        fail("hybrid gm50k float32: not 2 host syncs per iteration")
    consensus_steps("gm50k float32", hs, card)
    kernel_vs_twin("hybrid gm50k", hs.host, None, card, errs, times, flush, state=hs.state)
    paths.append({"at": "hybrid gm50k", "dt": "float32", "suffix": "", "launches": counted,
                  "iterations": GM_HYBRID_ITERS})
    hs.close()
    del hs

    # ---- (d) "hybrid mma" through BddSolver on grid12 with rounding, the
    # 264 BDDs of depth 16 on the host
    ilp = grid_mrf(12, 12, 4, seed=0)
    sk.reset_launch_counts()
    before = plain_calls()
    t0 = time.perf_counter()
    s = BddSolver({"relaxation solver": "hybrid mma", "hybrid hop threshold": 5},
                  device="cuda").read_ilp(ilp=ilp)
    res = s.solve(verbose=False)
    wall = time.perf_counter() - t0
    checked_solution(ilp, res, "hybrid mma grid12")
    if (not isinstance(s.solver, HybridSolver) or not s.solver.host_bdds
            or not s.solver.device_bdds or s.solver._pool is not None
            or plain_calls() != before or min(sk.LAUNCHES[k] for k in KERNELS) < res["iterations"]):
        fail(f"hybrid mma grid12: split {len(s.solver.host_bdds)} / {len(s.solver.device_bdds)}, "
             f"launches {dict(sk.LAUNCHES)}, plain versions {before} -> {plain_calls()}")
    print(f"[hybrid] grid12 'hybrid mma' with rounding, threshold 5: "
          f"{len(s.solver.host_bdds)} BDDs on the host, {len(s.solver.device_bdds)} on the card; "
          f"lb {res['lower_bound']!r}, objective {res['objective']!r}, {res['iterations']} dual "
          f"iterations, {wall:.2f} s wall; launches {dict(sk.LAUNCHES)} {card}", flush=True)
    del s
    if threading.active_count() != threads_before:
        fail(f"hybrid: {threading.active_count()} threads after close(), {threads_before} before")

    # ---- (e) extras on the card: phase 3's gm50k float32 state (500
    # iterations on the same layout: the same bits) to a float64 native
    # solver, and a checkpoint round trip
    sol = UniformSolver(gm_f32, gm_nh.objective())
    sol.iteration_block(GM_ITERS)
    lb32 = sol.lower_bound_with_deferred()
    if lb32 != gm_bound:
        fail(f"gm50k float32 state: bound {lb32!r}, phase 3 had {gm_bound!r}")
    cs = gm_nh.cpu_solver()
    t0 = time.perf_counter()
    extras.transfer_costs_to_native(sol.host, sol.state, cs)
    transfer_s = time.perf_counter() - t0
    after = cs.lower_bound_with_deferred()
    cs.iterations(100, 0.5)
    print(f"[extras] gm50k float32 -> float64 native: bound {lb32!r} on the card, {after!r} "
          f"after the transfer ({transfer_s:.3f} s), {cs.lower_bound_with_deferred()!r} after "
          f"100 float64 iterations {card}", flush=True)
    if not abs(after - lb32) <= 1e-4 * abs(lb32):
        fail(f"transfer_costs_to_native: bound {after!r} vs {lb32!r}")
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "gm50k.pkl")
        t0 = time.perf_counter()
        extras.save_state(sol, path)
        fresh = UniformSolver(gm_f32, gm_nh.objective())
        extras.load_state(fresh, path)
        ckpt_s = time.perf_counter() - t0
        size = os.path.getsize(path)
    sol.iteration_block(10)
    fresh.iteration_block(10)
    if not all(torch.equal(a, b) for a, b in zip(sol.state.flat, fresh.state.flat)):
        fail("checkpoint: the 10 iterations after load_state differ from the uninterrupted run")
    print(f"[extras] gm50k float32 checkpoint: {size} B saved and loaded in {ckpt_s:.3f} s; the "
          f"next 10 iterations bit-identical to the uninterrupted run {card}", flush=True)
    return paths


LEARNED_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks",
                            "doge_gm120.ckpt")
LEARNED_SEED = 100  # the held-out instance of benchmarks/train_doge_scale.py
LEARNED_TRAIN_ROUNDS = 2  # depth cut of the checkpoint's 20: one pre-round, one with gradients
# the rollout's depth: 10 of the checkpoint's 20 rounds of 20 iterations
# (cut in PR 8 to keep the whole script near its budget)
LEARNED_ROLLOUT_ROUNDS = 5  # depth cut from the checkpoint's 20 to keep the script in its budget
LEARNED_MMA_ITERS = 100  # as many iterations as the rollout
LEARNED_TWIN_ROUNDS = 1  # one round shows the twins equal to the kernels
LEARNED_PROFILE_ROUNDS = 1  # the profiler processes every one of a round's ~70,500 launches
GRAD_REL = 1e-6
LEARNED_TRAIN_STEPS = 1  # cut from 2 (PR 8): one step moves the parameters and counts launches


def learned_vs_twin(label, geom, state, alpha, omega, card, errs, times, flush):
    """Phase 14 (a) on one layout: the GNN's per-layer alpha and omega through
    one fused forward and one fused backward launch against the twins bucket
    by bucket (bit-equal), each timed warm and cold beside its byte bound
    (alpha and omega count as arrays), then the run-only entry on the
    updated costs (``run_vs_plain``)."""
    import torch
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf

    dt = str(geom.dtype).replace("torch.", "")
    itemsize = torch.empty((), dtype=geom.dtype).element_size()
    check_index_on_card(label, geom)
    lo, hi, mm, cft = state.flat
    dl, dh = uf.exchange_delta_flat(geom, mm)
    args_f = (geom, lo, hi, cft, omega, dl, dh)
    ref_f = uf.sweep_per_bucket(uf.bucket_forward_iteration, *args_f, alpha)
    dl2, dh2 = uf.exchange_delta_flat(geom, ref_f[2])
    args_b = (geom, ref_f[0], ref_f[1], ref_f[3], omega, dl2, dh2)
    ref_b = uf.sweep_per_bucket(uf.bucket_backward_iteration, *args_b, alpha)
    entry = times.setdefault((label, dt), {})
    bodies = [r.body for r in geom.plan.sweeps]
    for name, wrapper, twin, args, ref, fwd in (
            ("uniform_forward", sk.forward_iteration_cuda, uf.bucket_forward_iteration, args_f,
             ref_f, True),
            ("uniform_backward", sk.backward_iteration_cuda, uf.bucket_backward_iteration,
             args_b, ref_b, False)):
        before = dict(sk.LAUNCHES)
        out = wrapper(*args, alpha)
        torch.cuda.synchronize()
        err = compare(out, ref, TOL[dt])
        for body in bodies:
            errs[name + body] = max(errs[name + body], err)
        rose = {k: n - before[k] for k, n in sk.LAUNCHES.items() if n != before[k]}
        if rose != {name + body: 1 for body in bodies}:
            fail(f"{label}: one fused learned {name} call counted launches {rose}")
        launch, _ = sk.prepare_fused_launch(name, *args, alpha=alpha)
        nbytes = launch_bytes(bdd_shapes(geom.buckets), itemsize, fwd, omega_array=True)
        e = entry[name] = {
            "ms": cuda_ms(launch, 200), "cold_ms": cuda_ms(launch, 20, flush),
            "plain_ms": cuda_ms(lambda: uf.sweep_per_bucket(twin, *args, alpha), 2),
            "bytes": nbytes, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
        print(f"[learned] {label} {dt} {name} with the GNN's alpha and omega arrays over "
              f"{len(geom.buckets)} bucket(s) {[(g.P, g.H, g.B) for g in geom.buckets][:6]}: "
              f"equal to the twins (max |diff| {err}, same ±inf pattern); warm {e['ms']:.4f} ms "
              f"({share(e['bound_ms'], e['ms'])}), cold {e['cold_ms']:.4f} ms "
              f"({share(e['bound_ms'], e['cold_ms'])}), bound {e['bound_ms']:.4f} ms = "
              f"{nbytes} B at 3.35 TB/s; twins {e['plain_ms']:.4f} ms {card}", flush=True)
    run_vs_plain(label, geom, ref_b[0], ref_b[1], card, errs, entry, flush, "")


def per_body(geom, n: int) -> dict:
    """The half-sweep launch counts of n iterations on ``geom``: n of either
    kernel for each body the layout has."""
    return {**launch_counts(), **{k + r.body: n for k in KERNELS for r in geom.plan.sweeps}}


def rollout_syncs(trainer, inst, nr_rounds):
    """A fused rollout of the checkpoint's rounds with torch's sync debug
    mode on: (bounds, wall seconds, host syncs with their call sites)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            lbs = trainer.run_learned_rounds(inst, nr_rounds)
            wall = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    return lbs, wall, syncs


def profile_rollout(label, trainer, inst, card):
    """torch.profiler over a short rollout: per round the host time of each
    span of ``learn.train.SPANS`` and the device time of the kernels under
    it, the device busy share, launches per round, and host syncs between
    the first and last kernel launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bdd_tpu_torch.learn.train import SPANS

    n = LEARNED_PROFILE_ROUNDS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_learned_rounds(inst, n)
        wall = time.perf_counter() - t0
    events = list(prof.events())
    launches = [e.time_range.start for e in events if e.name == "cudaLaunchKernel"]
    if not launches:
        fail(f"{label}: the profiler saw no kernel launch in a rollout")
    first, last = min(launches), max(launches)
    syncs = sum(1 for e in events if e.name in SYNC_EVENTS and first <= e.time_range.start <= last)
    # a span shows twice: its host range and its device range
    spans = {k: [0.0, 0.0] for k in SPANS}
    device_us = 0.0
    for a in prof.key_averages():
        dev = getattr(a, "device_time_total", None) or getattr(a, "cuda_time_total", 0.0)
        if a.key in SPANS:
            spans[a.key][0] = max(spans[a.key][0], a.cpu_time_total / 1e3 / n)
            spans[a.key][1] = max(spans[a.key][1], dev / 1e3 / n)
            continue
        device_us += getattr(a, "self_device_time_total", None) or getattr(
            a, "self_cuda_time_total", 0.0)
    split = ", ".join(f"{k.split('.')[1]} {h:.2f} ms host / {d:.2f} ms device"
                      for k, (h, d) in spans.items())
    print(f"[learned] {label} profiled rollout of {n} rounds: wall {1e3 * wall / n:.2f} ms a "
          f"round (under the profiler); by span: {split}; device busy {device_us / 1e3 / n:.2f} "
          f"ms a round (busy share {device_us / 1e6 / wall:.3f}); {len(launches) / n:.0f} kernel "
          f"launches a round; host syncs between the first and last launch {syncs} {card}",
          flush=True)
    if syncs:
        fail(f"{label}: {syncs} host syncs inside a fused rollout")
    return spans


def phase_learned(card, errs, times, flush, gm_python):
    """Phase 14: the learned solver (DOGE) from the JAX package's trained
    ``doge_gm120.ckpt`` on gm120 seed 100 (float32, the Python pipeline the
    trainer builds with): (a) the kernels with the GNN's alpha and omega
    against the twins; (b) the checkpoint's rollout (5 of its 20 rounds of
    20 iterations) with one host
    sync, its time by span, plain MMA on the same layout for as many
    iterations, and the first rounds through the twins, bit-equal; (c) a
    training step on gm120 seed 0 (phase 10's Python build), depth cut to
    2 rounds, whose gradients equal plain autograd through the twins."""
    import torch
    from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor
    from bdd_tpu_torch.ilp import parse_lp_string
    from bdd_tpu_torch.learn import checkpoint
    from bdd_tpu_torch.learn import train as tr
    from bdd_tpu_torch.solver import layout
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf
    from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver

    paths = []
    # ---- gm120 seed 100 through the trainer's pipeline, the checkpoint
    t0 = time.perf_counter()
    ilp = parse_lp_string(gm50k_lp(LEARNED_SEED))
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    host = layout.flatten_uniform(pre.collection, pre.total_nr_variables(),
                                  pre.nr_primal_variables, dtype=torch.float32,
                                  device=layout.resolve_device("cuda"))
    inst = tr.Instance(host, pre.objective_vector(), pre=pre)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer = tr.DogeTrainer()
    trainer.load(LEARNED_CKPT, inst)
    cfg = trainer.cfg
    print(f"[learned] gm120 seed {LEARNED_SEED}: {host.nr_bdds} BDDs, {host.nr_vars} variables, "
          f"buckets {[(g.P, g.H, g.B) for g in host.geom.buckets]}, built in {build_s:.2f} s; "
          f"{LEARNED_CKPT} ({len(checkpoint.load(LEARNED_CKPT)[1])} tensors, config {cfg}) "
          f"loaded through the port's reader in {time.perf_counter() - t0:.2f} s {card}",
          flush=True)
    geom = host.geom
    # ---- (a) the kernels with the GNN's weights, against the twins
    with torch.no_grad():
        alpha, omega, update, _ = trainer._predict(
            inst, inst.state0, trainer._zero_lstm(inst), trainer._zero_history(inst))
        state = trainer._apply_free_update(geom, inst.state0, update)
    learned_vs_twin("gm120 learned", geom, state, alpha, omega, card, errs, times, flush)
    # ---- (b) the checkpoint's rollout: one host sync, bounds, time by span
    trainer.run_learned_rounds(inst, 1)  # warm
    sk.reset_launch_counts()
    before = plain_calls()
    lbs, wall, syncs = rollout_syncs(trainer, inst, LEARNED_ROLLOUT_ROUNDS)
    counted = dict(sk.LAUNCHES)
    n_rounds, iters = LEARNED_ROLLOUT_ROUNDS, cfg.iters_per_round
    if len(syncs) != 1:
        fail(f"gm120 rollout: {len(syncs)} host syncs, expected 1: {syncs[:20]}")
    if plain_calls() != before or not all(map(math.isfinite, lbs)):
        fail(f"gm120 rollout: bounds {lbs}, plain versions {before} -> {plain_calls()}")
    want = n_rounds * iters
    if sweeps_of(counted) != per_body(geom, want):
        fail(f"gm120 rollout: launches {counted}, expected one of each half-sweep per body and "
             f"learned iteration ({want})")
    print(f"[learned] gm120 seed {LEARNED_SEED} rollout, {n_rounds} rounds x {iters} iterations "
          f"(fused): bounds {lbs}; best {max(lbs)!r}; {1e3 * wall / n_rounds:.2f} ms a round, "
          f"{wall:.2f} s wall; host syncs {len(syncs)} ({syncs}); launches {counted} {card}",
          flush=True)
    profile_rollout("gm120 learned", trainer, inst, card)
    paths.append({"at": "gm120 learned", "dt": "float32", "suffix": "", "launches": counted,
                  "iterations": want})
    # plain MMA on the same layout for as many iterations (printed, not gated)
    sol = UniformSolver(host, pre.objective_vector())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol.iteration_block(LEARNED_MMA_ITERS)
    mma_lb = sol.lower_bound_with_deferred()
    mma_s = time.perf_counter() - t0
    print(f"[learned] gm120 seed {LEARNED_SEED}: plain MMA on the same layout, "
          f"{LEARNED_MMA_ITERS} iterations: lb {mma_lb!r} in {mma_s:.3f} s "
          f"({1e3 * mma_s / LEARNED_MMA_ITERS:.4f} ms an iteration); the learned rollout's last "
          f"bound {lbs[-1]!r}, best {max(lbs)!r} ({1e3 * wall / want:.4f} ms a learned "
          f"iteration with its share of features and GNN) {card}", flush=True)
    # the first rounds through the twins: the same bounds to the last bit
    trainer.sweeps = uf.TWIN_SWEEPS
    t0 = time.perf_counter()
    twin = trainer.run_learned_rounds(inst, LEARNED_TWIN_ROUNDS)
    twin_s = time.perf_counter() - t0
    trainer.sweeps = None
    if twin != lbs[:LEARNED_TWIN_ROUNDS]:
        fail(f"gm120 rollout: the twins' first rounds {twin} vs the kernels' "
             f"{lbs[:LEARNED_TWIN_ROUNDS]}")
    print(f"[learned] the first {LEARNED_TWIN_ROUNDS} rounds through the twins on the card equal "
          f"the kernels' bit for bit ({twin}); {twin_s:.2f} s {card}", flush=True)
    # ---- (c) training on gm120 seed 0: gradients, then a step
    t_host, t_objective, t_pre = gm_python[:3]
    t0 = time.perf_counter()
    tinst = tr.Instance(t_host, t_objective, pre=t_pre)
    trainer = tr.DogeTrainer()
    trainer.load(LEARNED_CKPT, tinst)
    trainer.cfg = dataclasses.replace(trainer.cfg, nr_rounds=LEARNED_TRAIN_ROUNDS)
    cfg = trainer.cfg
    print(f"[learned] gm120 seed 0 (phase 10's Python build, buckets "
          f"{[(g.P, g.H, g.B) for g in t_host.geom.buckets]}): instance and checkpoint in "
          f"{time.perf_counter() - t0:.2f} s; training depth cut to {cfg.nr_rounds} rounds of "
          f"{cfg.iters_per_round} ({cfg.grad_rounds} with gradients) {card}", flush=True)
    with torch.no_grad():
        alpha, omega, update, _ = trainer._predict(
            tinst, tinst.state0, trainer._zero_lstm(tinst), trainer._zero_history(tinst))
        state = trainer._apply_free_update(t_host.geom, tinst.state0, update)
    learned_vs_twin("gm120 train", t_host.geom, state, alpha, omega, card, errs, times, flush)
    grads, losses = [], []
    ways = {None: "kernels forward, twins recomputed backward",
            uf.TWIN_SWEEPS: "twins both ways, plain autograd"}
    for sweeps in ways:
        trainer.sweeps = sweeps
        trainer.opt.zero_grad(set_to_none=True)
        sk.reset_launch_counts()
        twins_before = dict(uf.TWIN_SWEEP_CALLS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.loss_and_grads(tinst)
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
        grads.append({k: p.grad.clone() for k, p in trainer.model.named_parameters()})
        losses.append(loss.item())
        twin_calls = {k: uf.TWIN_SWEEP_CALLS[k] - twins_before[k] for k in twins_before}
        print(f"[learned] gm120 seed 0 loss and gradients, {ways[sweeps]}: loss "
              f"{losses[-1]!r} in {grad_s:.2f} s; launches {dict(sk.LAUNCHES)}; twin half-sweeps "
              f"{twin_calls} {card}", flush=True)
        if sweeps is None:
            learned = cfg.nr_rounds * cfg.iters_per_round
            if sweeps_of(sk.LAUNCHES) != per_body(t_host.geom, learned):
                fail(f"gm120 training: launches {dict(sk.LAUNCHES)}, expected {learned} of each "
                     f"half-sweep (one per learned iteration)")
    trainer.sweeps = None
    scale = max(float(g.abs().max()) for g in grads[1].values())
    diff = max(float((grads[0][k] - grads[1][k]).abs().max()) for k in grads[1])
    if losses[0] != losses[1] or not 0 < scale < math.inf or not diff <= GRAD_REL * scale:
        fail(f"gm120 training: losses {losses}, gradients max |diff| {diff} against their "
             f"largest entry {scale} (limit rel {GRAD_REL})")
    print(f"[learned] gm120 seed 0: LearnedIteration / BackwardRun gradients equal plain "
          f"autograd through the twins: max |diff| {diff:.3e} over {len(grads[1])} parameter "
          f"tensors, {diff / scale:.3e} of the largest entry {scale:.3e} (limit {GRAD_REL}); "
          f"losses bit-equal ({losses[0]!r}) {card}", flush=True)
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    sk.reset_launch_counts()
    steps = []
    for _ in range(LEARNED_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.append((trainer.train_step(tinst)["loss"], time.perf_counter() - t0))
    counted = dict(sk.LAUNCHES)
    moved = max(float((v - start[k]).abs().max()) for k, v in trainer.model.state_dict().items())
    learned = LEARNED_TRAIN_STEPS * cfg.nr_rounds * cfg.iters_per_round
    if (not all(math.isfinite(l) for l, _ in steps) or not moved > 0
            or sweeps_of(counted) != per_body(t_host.geom, learned)):
        fail(f"gm120 training: steps {steps}, parameters moved {moved}, launches {counted}")
    print(f"[learned] gm120 seed 0: {LEARNED_TRAIN_STEPS} training step(s): losses "
          f"{[l for l, _ in steps]}, "
          f"{[round(s, 2) for _, s in steps]} s; parameters moved up to {moved:.3e}; launches "
          f"{counted} ({learned} learned iterations) {card}", flush=True)
    paths.append({"at": "gm120 train", "dt": "float32", "suffix": "", "launches": counted,
                  "iterations": learned})
    return paths


# ------------------------------------------------------------ 15. sharded
SHARDED_RANKS = 2  # rank processes on the one card (gloo: NCCL refuses two ranks a card)
SHARDED_TIMEOUT_S = 400
SHARDED_LBFGS_ITERS = 50
COMM_REPS = 20


def rank_card(rank: int, size: int, backend: str) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return f"[{smi}; rank {rank} of {size}, {backend}]"


def expected_sweeps(geom, n: int) -> dict:
    """The half-sweep launches of n iterations on ``geom``: one a body that
    holds a bucket, per kernel and iteration."""
    return per_body(geom, n)


def collective_ms(comm, t, reps: int = COMM_REPS) -> float:
    """Host ms per all_reduce of ``t`` (every rank in step; each ends when
    the sum is back in ``t`` on the card)."""
    import torch

    comm.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        comm.all_reduce_(t)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def profile_sharded(s, n: int = 10) -> dict:
    """torch.profiler over n sharded iterations: host syncs per iteration
    (by kind, the device-to-host copies of the backend's staging included),
    device busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    s.iteration_block(2)  # warm
    torch.cuda.synchronize()
    s.comm.barrier()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.iteration_block(n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    syncs = {}
    for e in prof.events():
        if e.name in SYNC_EVENTS or e.name == "cudaMemcpy":
            syncs[e.name] = syncs.get(e.name, 0) + 1
    device_us = sum(getattr(a, "self_device_time_total", None) or getattr(
        a, "self_cuda_time_total", 0.0) for a in prof.key_averages())
    if device_us <= 0:
        fail("the profiler recorded no device time in a sharded block")
    return {"syncs_per_iteration": sum(v for k, v in syncs.items() if k in SYNC_EVENTS) / n,
            "syncs": {k: v / n for k, v in syncs.items()}, "wall_ms": 1e3 * wall / n,
            "busy_ms": device_us / 1e3 / n, "busy_share": device_us / 1e6 / wall}


def sharded_solve(label, s, card) -> dict:
    """GM_ITERS iterations of a sharded solver, timed; the global bound, the
    launches counted in this rank's run (every one a kernel's: no plain
    sweep or run), the collectives per iteration and their payload."""
    import torch
    from bdd_tpu_torch.solver import sweep_kernels as sk

    comm = s.comm
    plain = plain_calls()
    sk.reset_launch_counts()
    comm.calls = comm.bytes = 0
    torch.cuda.synchronize()
    comm.barrier()
    t0 = time.perf_counter()
    s.iteration_block(GM_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls, nbytes = comm.calls, comm.bytes
    lb = s.lower_bound()  # the deltas distributed: one launch of the run entry a body
    launches = dict(sk.LAUNCHES)
    if plain_calls() != plain:
        fail(f"{label}: a plain sweep or run ran in the sharded solve: {plain_calls()} vs {plain}")
    if sweeps_of(launches) != expected_sweeps(s.geom, GM_ITERS):
        fail(f"{label}: launches {launches}, expected {expected_sweeps(s.geom, GM_ITERS)}")
    out = {"lb": lb, "its_per_s": GM_ITERS / wall, "launches": launches,
           "collectives_per_iteration": calls / GM_ITERS,
           "bytes_per_collective": nbytes / max(calls, 1)}
    print(f"[sharded] {label}: lb {lb!r} after {GM_ITERS} iterations, {out['its_per_s']:.1f} it/s "
          f"per rank; {out['collectives_per_iteration']:.2f} all_reduce an iteration of "
          f"{out['bytes_per_collective']:.0f} B; launches {launches} {card}", flush=True)
    return out


def nccl_one_rank(group, card) -> dict:
    """grid12 float32 on a process group of one rank over NCCL, every row of
    the sums through the backend, against the one-device solver on the same
    collection."""
    import torch
    from bdd_tpu_torch.native import NativeHost
    from bdd_tpu_torch.solver.uniform_sharded import ShardedUniformSolver
    from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver
    from bdd_tpu_torch.utils.problems import grid_mrf

    nh = NativeHost(grid_mrf(12, 12, 4, seed=0).write_lp(), "bfs")
    collection, V, obj = nh.collection(), nh.nr_vars(), nh.objective()
    s = ShardedUniformSolver(collection, V, obj, group=group, dtype=torch.float32,
                             plan_family="global")
    res = sharded_solve("grid12 float32, one rank, every row through NCCL", s, card)
    one = UniformSolver.from_collection(collection, V, obj, dtype=torch.float32)
    one.iteration_block(GM_ITERS)
    res["one_device_lb"] = one.lower_bound_with_deferred()
    res["profile"] = p = profile_sharded(s)
    print(f"[sharded] one rank, NCCL: lb {res['lb']!r}, the one-device solver on the same "
          f"collection {res['one_device_lb']!r}; {p['syncs_per_iteration']:.2f} host syncs an "
          f"iteration {p['syncs']}, wall {p['wall_ms']:.4f} ms, busy share "
          f"{p['busy_share']:.3f} {card}", flush=True)
    return res


def sharded_rank(argv) -> None:
    """One rank of phase 15 (``chip_smoke.py --sharded-rank RANK SIZE PORT
    OUTDIR LP``), on the one card over gloo: the gm50k LP through the
    native host library to a BDD collection, float32 and float64 sharded
    solves with partition "auto", the collectives timed, a profiled block,
    the kernels against the twins on rank 0's shard layout, "lbfgs sharded
    mma" and "sharded mma" through BddSolver on grid12, one
    ShardedDogeTrainer step, the dense sharded solve (:func:`sharded_dense`);
    then rank 0 alone in a process group of its own over NCCL
    (:func:`nccl_one_rank`). Writes OUTDIR/rank<R>.json."""
    import torch
    import torch.distributed as dist

    rank, size, port, outdir, lp_path = (
        int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4])
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: a rank of phase 15 needs an NVIDIA GPU")
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * size)))
    card = rank_card(rank, size, "gloo")
    from bdd_tpu_torch import _build
    from bdd_tpu_torch.native import NativeHost
    from bdd_tpu_torch.solver.uniform_sharded import ShardedUniformSolver
    from bdd_tpu_torch.utils import multihost as mh

    _build.load()
    t0 = time.perf_counter()
    mh.initialize(f"localhost:{port}", size, rank, platform="cuda", backend="gloo")
    out = {"rank": rank, "size": size, "init_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    with open(lp_path) as fh:
        nh = NativeHost(fh.read(), "bfs")
    collection = nh.collection()
    V, obj = nh.nr_vars(), nh.objective()
    out["native_s"] = time.perf_counter() - t0
    errs = {name + suffix: 0.0 for name in KERNELS + (RUN,) for suffix in BODIES}
    times = {}

    def build(label, **kw):
        t = time.perf_counter()
        s = ShardedUniformSolver(collection, V, obj, **kw)
        built = time.perf_counter() - t
        geom = s.geom
        print(f"[sharded] {label} rank {rank}: {len(s.layout.parts[rank])} of "
              f"{collection.nr_bdds()} BDDs, buckets {[tuple(x) for x in geom.plan.shapes]}, "
              f"{s.layout.shared.size} variables shared of {V}; built in {built:.2f} s "
              f"(native host library {out['native_s']:.2f} s) {card}", flush=True)
        return s, built

    s32, out["build32_s"] = build("gm50k float32", dtype=torch.float32, partition="auto")
    s64, out["build64_s"] = build("gm50k float64", dtype=torch.float64, like=s32.layout)
    out["bdds"] = [len(p) for p in s32.layout.parts]
    out["shared"] = int(s32.layout.shared.size)
    for dt, s in (("float32", s32), ("float64", s64)):
        res = sharded_solve(f"gm50k {dt}", s, card)
        rows = torch.zeros(int(s.rows.numel()), 2, dtype=s.dtype, device=s.device)
        every = torch.zeros(V + 1, 2, dtype=s.dtype, device=s.device)
        res["shared_ms"] = collective_ms(s.comm, rows)
        res["all_rows_ms"] = collective_ms(s.comm, every)
        res["host_ms"] = collective_ms(s.comm, rows.cpu())  # gloo alone, no staging
        res["shared_bytes"] = rows.numel() * rows.element_size()
        res["all_rows_bytes"] = every.numel() * every.element_size()
        res["profile"] = profile_sharded(s)
        p = res["profile"]
        print(f"[sharded] gm50k {dt}: one all_reduce of the shared rows "
              f"{res['shared_ms']:.4f} ms ({res['shared_bytes']} B; the same rows on the "
              f"host, no staging: {res['host_ms']:.4f} ms), of all rows "
              f"{res['all_rows_ms']:.4f} ms ({res['all_rows_bytes']} B); profiled block: "
              f"{p['syncs_per_iteration']:.2f} host syncs an iteration {p['syncs']}, wall "
              f"{p['wall_ms']:.4f} ms, device busy {p['busy_ms']:.4f} ms an iteration (busy "
              f"share {p['busy_share']:.3f}, under the profiler) {card}", flush=True)
        out[dt] = res
    if rank == 0:
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        for s in (s32, s64):
            kernel_vs_twin("sharded gm50k", s.host, obj, card, errs, times, flush,
                           state=s.state)
        del flush
    s32.comm.barrier()
    out["errs"] = errs
    out["times"] = {f"{label}|{dt}": e for (label, dt), e in times.items()}
    out["lbfgs"] = sharded_lbfgs(card)
    out["doge"] = sharded_doge(s32, obj, card)
    out["dense"] = sharded_dense(rank, collection, V, obj, card)
    # one rank over NCCL: a process group of rank 0 alone (NCCL refuses two
    # ranks a card); every rank of the world takes part in making it
    nccl = dist.new_group(ranks=[0], backend="nccl")
    if rank == 0:
        out["nccl"] = nccl_one_rank(nccl, rank_card(0, 1, "nccl"))
    s32.comm.barrier()
    mh.shutdown()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "bdd_tpu", "flax", "optax", "msgpack"))
    if foreign:
        fail(f"a rank imported JAX or the JAX package: {foreign[:5]}")
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


def sharded_lbfgs(card) -> dict:
    """grid12 float64 through BddSolver: "lbfgs sharded mma" and "sharded
    mma", dual only, SHARDED_LBFGS_ITERS iterations each."""
    import torch
    from bdd_tpu_torch.api import BddSolver
    from bdd_tpu_torch.utils.problems import grid_mrf

    out = {}
    for name in ("lbfgs sharded mma", "sharded mma"):
        cfg = {"relaxation solver": name, "precision": "double", "perturbation rounding": False,
               **fixed_iterations(SHARDED_LBFGS_ITERS)}
        t0 = time.perf_counter()
        res = BddSolver(cfg, device="cuda").read_ilp(ilp=grid_mrf(12, 12, 4, seed=0)).solve(
            verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if res["status"] != "solved" or not math.isfinite(res["lower_bound"]):
            fail(f"grid12 {name}: {res['status']}, lb {res['lower_bound']}")
        out[name] = {"lb": res["lower_bound"], "iterations": res["iterations"],
                     "solve_s": res["solve_time"], "wall_s": wall}
        print(f"[sharded] grid12 float64 {name!r} through BddSolver: lb {res['lower_bound']!r} "
              f"after {res['iterations']} iterations, solve {res['solve_time']} s, "
              f"{wall:.2f} s with the Python build {card}", flush=True)
    return out


def sharded_doge(s, objective, card) -> dict:
    """One ShardedDogeTrainer step on the float32 gm50k shards (gm120 seed
    0), cut to LEARNED_TRAIN_ROUNDS rounds as phase 14 is; the checkpoint's
    configuration without its history features (the sharded trainer has
    none), a fresh model from its seed. Finite loss; every rank holds the same
    parameters after the step."""
    import torch
    from bdd_tpu_torch.learn import checkpoint
    from bdd_tpu_torch.learn.sharded import ShardedDogeTrainer
    from bdd_tpu_torch.learn.train import TrainConfig
    from bdd_tpu_torch.solver import sweep_kernels as sk

    cfg_d, _ = checkpoint.load(LEARNED_CKPT)
    cfg_d.update(nr_rounds=LEARNED_TRAIN_ROUNDS, history_features=False,
                 smooth_temps=tuple(cfg_d["smooth_temps"]))
    cfg = TrainConfig(**cfg_d)
    t0 = time.perf_counter()
    tr = ShardedDogeTrainer(s, objective, cfg)
    tr.init()
    init_s = time.perf_counter() - t0
    sk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = tr.train_step()["loss"]
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    flat = torch.cat([p.detach().reshape(-1) for p in tr.model.parameters()])
    spread = float((s.comm.all_gather(flat) - flat).abs().max())
    learned = cfg.nr_rounds * cfg.iters_per_round
    if not math.isfinite(loss) or spread != 0.0 or min(launches[k] for k in KERNELS) == 0:
        fail(f"sharded DOGE step: loss {loss}, parameters differ across ranks by {spread}, "
             f"launches {launches}")
    print(f"[sharded] ShardedDogeTrainer on gm120 seed 0 ({cfg.nr_rounds} rounds of "
          f"{cfg.iters_per_round}, {cfg.grad_rounds} with gradients): global view and model in "
          f"{init_s:.2f} s, a step {step_s:.2f} s, loss {loss!r}; parameters equal on every rank; "
          f"launches {launches} ({learned} learned iterations) {card}", flush=True)
    return {"loss": loss, "step_s": step_s, "init_s": init_s, "launches": launches}


def run_ranks(size: int, lp_path: str, outdir: str, meanwhile=None):
    """Start ``size`` rank processes of this script on the card, run
    ``meanwhile()`` (if given) in this process while they work, echo their
    output, fail if one fails or outlasts SHARDED_TIMEOUT_S; (their JSON,
    what ``meanwhile`` returned)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    logs = [open(os.path.join(outdir, f"rank{r}.log"), "w+") for r in range(size)]
    # the ranks share the host's cores: a passive OpenMP pool of their own
    # size (the native baseline's active spin would take the cores the
    # collectives' threads need)
    threads = str(max(1, (os.cpu_count() or 2) // (2 * size)))
    env = dict(os.environ, OMP_WAIT_POLICY="passive", OMP_NUM_THREADS=threads)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-rank", str(r), str(size),
         str(port), outdir, lp_path], stdout=log, stderr=subprocess.STDOUT, env=env)
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    try:
        extra = meanwhile() if meanwhile is not None else None
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        fail(f"a rank outlasted {SHARDED_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        lines = text.splitlines()
        if p.returncode != 0:
            print("\n".join(lines[-40:]), file=sys.stderr, flush=True)
            fail(f"rank {r} of {size} exited with {p.returncode}")
        print("\n".join(line for line in lines if line.startswith("[")), flush=True)
    out = []
    for r in range(size):
        with open(os.path.join(outdir, f"rank{r}.json")) as fh:
            out.append(json.load(fh))
    return out, extra


def dense_reference(gm_lp: str, card) -> dict:
    """The one-device DenseSolver on the collection the ranks of phase 15
    solve (gm50k through the native host library), float32 and float64,
    DENSE_SHARDED_ITERS iterations: the reference of the dense sharded solve.
    Run in the parent while the ranks build their layouts (host work; their
    first card work comes after it), so that it adds no time to the phase."""
    import torch
    from bdd_tpu_torch.native import NativeHost
    from bdd_tpu_torch.solver.dense_wrapper import DenseSolver
    from bdd_tpu_torch.solver.flatten import densify, flatten_collection

    t0 = time.perf_counter()
    nh = NativeHost(gm_lp, "bfs")
    V = nh.nr_vars()
    flat = flatten_collection(nh.collection(), V, V)
    dense = densify(flat)
    out = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]

        def solve():
            one = DenseSolver(flat, nh.objective(), dtype=dt, device="cuda", dense=dense)
            one.iteration_block(DENSE_SHARDED_ITERS)
            return one.lower_bound_with_deferred()

        out[name] = dense_guard(f"one-device dense gm50k {name}", solve)
    out["s"] = time.perf_counter() - t0
    print(f"[sharded] the one-device DenseSolver on the ranks' gm50k collection (H={dense.H} "
          f"W={dense.W} L={dense.L}), {DENSE_SHARDED_ITERS} iterations, in this process while "
          f"the ranks built their layouts: float32 {out['float32']!r}, float64 "
          f"{out['float64']!r}; {out['s']:.2f} s {card}", flush=True)
    return out


def phase_sharded(card, errs, times, gm_lp, gm_ref):
    """Phase 15: the sharded solve. Two rank processes on the one card
    (gloo, which stages the card's tensors through the host; NCCL refuses
    two ranks a card) solve gm50k (phase 3's LP, 50,701 BDDs, partition
    "auto") for GM_ITERS iterations in float32 and float64, held to phase
    3's one-device bound and to the native solver (rel 1e-3 / 1e-7); the
    kernels against the twins on rank 0's shard layout; the collectives
    timed over the shared rows and over all rows; host syncs and device busy
    share of a profiled block; "lbfgs sharded mma" on grid12 through
    BddSolver; one ShardedDogeTrainer step; the dense sharded solve against
    a one-device DenseSolver that this process runs meanwhile
    (:func:`dense_reference`). Then rank 0 alone in a process group over
    NCCL on grid12 (every row of the sums through the backend) against the
    one-device solver. ``gm_ref``: phase 3's bounds."""
    import shutil
    import tempfile

    outdir = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        lp_path = os.path.join(outdir, "gm50k.lp")
        with open(lp_path, "w") as fh:
            fh.write(gm_lp)
        t0 = time.perf_counter()
        ranks, one_device = run_ranks(SHARDED_RANKS, lp_path, outdir,
                                      lambda: dense_reference(gm_lp, card))
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    r0 = ranks[0]

    def bounds(r):
        return (r["float32"]["lb"], r["float64"]["lb"],
                {name: v["lb"] for name, v in r["lbfgs"].items()}, r["doge"]["loss"],
                r["dense"]["float32"]["lb"], r["dense"]["float64"]["lb"])

    if any(bounds(r) != bounds(r0) for r in ranks):
        fail(f"the ranks' bounds differ: {[bounds(r) for r in ranks]}")
    paths = []
    for dt, prec in (("float32", "float"), ("float64", "double")):
        lb = r0[dt]["lb"]
        for what, ref in (("phase 3's one-device bound", gm_ref[dt]),
                          ("the native solver", gm_ref["native"])):
            rel = abs(lb - ref) / abs(ref)
            print(f"[sharded] gm50k {dt}, {SHARDED_RANKS} ranks: lb {lb!r} vs {what} {ref!r}: "
                  f"rel diff {rel:.3e} (limit {LB_REL[prec]}) {card}", flush=True)
            if not rel <= LB_REL[prec]:
                fail(f"sharded gm50k {dt} bound off {what}")
        paths.append({"at": f"sharded gm50k (rank 0 of {SHARDED_RANKS})", "dt": dt, "suffix": "",
                      "launches": r0[dt]["launches"], "iterations": GM_ITERS})
    for key, e in r0["times"].items():
        label, dt = key.split("|")
        times[(f"{label} (rank 0 of {SHARDED_RANKS})", dt)] = e
    for k, v in r0["errs"].items():
        errs[k] = max(errs[k], v)
    lb_l, lb_m = (r0["lbfgs"][n]["lb"] for n in ("lbfgs sharded mma", "sharded mma"))
    if not lb_l >= lb_m - 1e-6:
        fail(f"grid12: lbfgs sharded mma {lb_l!r} below sharded mma {lb_m!r}")
    for dt in ("float32", "float64"):
        d, ref = r0["dense"][dt], one_device[dt]
        rel = abs(d["lb"] - ref) / abs(ref)
        print(f"[sharded] dense gm50k {dt}, {SHARDED_RANKS} ranks: lb {d['lb']!r} after "
              f"{DENSE_SHARDED_ITERS} iterations vs the one-device DenseSolver's "
              f"{ref!r}: rel diff {rel:.3e} (limit {DENSE_SHARDED_REL[dt]}); "
              f"{[round(r['dense'][dt]['ms_per_iteration'], 2) for r in ranks]} ms an iteration, "
              f"an all_reduce of the [V + 1, 2] pair "
              f"{[round(r['dense'][dt]['all_reduce_ms'], 4) for r in ranks]} ms; every rank's "
              f"bound equal {card}", flush=True)
        if not rel <= DENSE_SHARDED_REL[dt]:
            fail(f"dense sharded gm50k {dt} bound off the one-device DenseSolver's")
    n32 = r0["nccl"]
    nrel = abs(n32["lb"] - n32["one_device_lb"]) / abs(n32["one_device_lb"])
    if not nrel <= LB_REL["float"]:
        fail(f"one NCCL rank: grid12 float32 bound {n32['lb']!r} vs the one-device solver's "
             f"{n32['one_device_lb']!r}")
    print(f"[sharded] summary: {SHARDED_RANKS} gloo ranks {ranks_s:.2f} s (init "
          f"{[round(r['init_s'], 2) for r in ranks]} s, native build "
          f"{[round(r['native_s'], 2) for r in ranks]} s, shard layouts float32 "
          f"{[round(r['build32_s'], 2) for r in ranks]} s, float64 "
          f"{[round(r['build64_s'], 2) for r in ranks]} s; BDDs per shard {r0['bdds']}, "
          f"{r0['shared']} shared variables); it/s per rank float32 "
          f"{[round(r['float32']['its_per_s'], 1) for r in ranks]}, float64 "
          f"{[round(r['float64']['its_per_s'], 1) for r in ranks]}; lbfgs sharded mma "
          f"{lb_l!r} >= sharded mma {lb_m!r}; DOGE step {r0['doge']['step_s']:.2f} s, loss "
          f"{r0['doge']['loss']!r}; one NCCL rank: grid12 float32 lb "
          f"{n32['lb']!r} (rel {nrel:.3e} to the one-device solver), "
          f"{n32['its_per_s']:.1f} it/s, {n32['profile']['syncs_per_iteration']:.2f} host syncs "
          f"an iteration {card}", flush=True)
    return paths


# gm50k: the dense solves (three of about 48 ms an iteration) and the
# uniform reference; depth cut from 200 to keep the script near its time
# budget on slower hosts (the comparison's limits are unchanged)
DENSE_ITERS = 100
DENSE_GRID_ITERS = 50  # grid12 float64: card against CPU
DENSE_TIGHTEN_ITERS = 30  # "dense mma" with and without "tighten", dual only
DENSE_API_ITERS = 100  # depth cut of the default 1,000 for the API solves (rounding as default)
DENSE_OUTER_ITERS = 100
DENSE_PROFILE_ITERS = 2
DENSE_PREFIX_ITERS = 20  # iterations before the prefix sweeps read the state
# phase 15's dense part (two ranks at about 90 ms an iteration, and the
# one-device reference); depth cut from 100 as DENSE_ITERS
DENSE_SHARDED_ITERS = 50
DENSE_REL = {"float32": 1e-3, "float64": 1e-9}  # dense vs uniform after the same iterations
DENSE_SHARDED_REL = {"float32": 1e-5, "float64": 1e-12}  # ranks vs one device


def dense_guard(what, fn):
    """fn() with the sweep kernels' launch counts and the plain versions'
    call counts held: the dense path launches no sweep kernel and calls no
    twin or plain run; fails otherwise."""
    from bdd_tpu_torch.solver import sweep_kernels as sk

    sk.reset_launch_counts()
    before = plain_calls()
    out = fn()
    if any(sk.LAUNCHES.values()) or plain_calls() != before:
        fail(f"{what}: the dense path moved the sweep kernels' counts {dict(sk.LAUNCHES)} or "
             f"the plain versions' {before} -> {plain_calls()}")
    return out


def profile_dense(label, solver, card, n=DENSE_PROFILE_ITERS) -> dict:
    """torch.profiler over one block of n dense iterations: kernel launches
    per iteration, device busy share, and the host syncs between the block's
    first and last launch (must be 0)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    solver.iteration_block(1)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.iteration_block(n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = list(prof.events())
    launches = [e.time_range.start for e in events if e.name in ("cudaLaunchKernel",
                                                                 "cudaLaunchKernelExC")]
    if not launches:
        fail(f"{label}: the profiler saw no kernel launch in a dense block")
    first, last = min(launches), max(launches)
    syncs = {}
    for e in events:
        if e.name in SYNC_EVENTS and first <= e.time_range.start <= last:
            syncs[e.name] = syncs.get(e.name, 0) + 1
    device_us = sum(getattr(a, "self_device_time_total", None) or getattr(
        a, "self_cuda_time_total", 0.0) for a in prof.key_averages())
    if device_us <= 0:
        fail(f"{label}: the profiler recorded no device time")
    out = {"launches_per_iteration": len(launches) / n, "syncs": sum(syncs.values()),
           "wall_ms": 1e3 * wall / n, "busy_ms": device_us / 1e3 / n,
           "busy_share": device_us / 1e6 / wall}
    print(f"[dense] {label} profiled block of {n} iterations: {out['launches_per_iteration']:.1f} "
          f"kernel launches an iteration, host syncs between first and last launch "
          f"{out['syncs']} {syncs}; wall {out['wall_ms']:.2f} ms, device busy "
          f"{out['busy_ms']:.3f} ms an iteration (busy share {out['busy_share']:.3f}, under the "
          f"profiler) {card}", flush=True)
    if out["syncs"]:
        fail(f"{label}: {out['syncs']} host syncs inside a dense block; expected 0")
    return out


def close_runs(what, got, want, dt) -> float:
    """Fails unless got and want (tensors) have the same ±inf pattern and
    agree to abs 1e-9 (float64) or rel 1e-5 (float32); the largest |diff|."""
    import torch

    fg, fw = torch.isfinite(got), torch.isfinite(want)
    if not torch.equal(fg, fw) or not torch.equal(got[~fg], want[~fw]):
        fail(f"{what}: the ±inf patterns differ")
    if not fg.any():
        return 0.0
    diff = (got[fg] - want[fw]).abs()
    err = float(diff.max())
    limit = (1e-9 if dt == torch.float64
             else 1e-5 * torch.clamp_min(want[fw].abs(), 1.0))
    if bool((diff > limit).any()):
        fail(f"{what}: max |diff| {err} over the limit ({dt})")
    return err


def phase_dense(card, gm_python, gm_prefix, gm_objective):
    """Phase 16: the dense backend ("dense mma", ``solver/dense.py``) on the
    card. ``gm_python``: phase 10's Python build of gm50k (host, objective,
    preprocessor, flat arrays); ``gm_prefix``:
    phase 2's unpacked gm50k layouts by dtype name."""
    import tempfile

    import torch
    from bdd_tpu_torch.api import BddSolver
    from bdd_tpu_torch.solver import extras
    from bdd_tpu_torch.solver import layout
    from bdd_tpu_torch.solver import prefix as px
    from bdd_tpu_torch.solver import uniform as uf
    from bdd_tpu_torch.solver.dense_wrapper import DenseSolver
    from bdd_tpu_torch.solver.flatten import densify
    from bdd_tpu_torch.solver.lbfgs import LbfgsSolver
    from bdd_tpu_torch.solver.subgradient import SubgradientSolver
    from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver
    from bdd_tpu_torch.utils.problems import grid_mrf

    out = {}
    # ---- (a) gm50k on phase 10's Python build: float32 twice, float64 once
    host32, objective, pre, flat = gm_python
    V, npv = pre.total_nr_variables(), pre.nr_primal_variables
    t0 = time.perf_counter()
    dense = densify(flat)
    build_s = time.perf_counter() - t0
    print(f"[dense] gm50k (phase 10's Python build, its flat arrays): {flat.nr_bdds} BDDs, "
          f"{flat.nr_nodes} nodes, H={dense.H} W={dense.W} L={dense.L}; densify {build_s:.2f} s "
          f"{card}", flush=True)

    def timed_solve(make, n):
        s = make()
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.iteration_block(n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return s, float(s.lower_bound_with_deferred()), n / wall

    solves = {}
    for run, dt in (("float32", torch.float32), ("float32 rerun", torch.float32),
                    ("float64", torch.float64)):
        solves[run] = dense_guard(f"gm50k dense {run}", lambda: timed_solve(
            lambda: DenseSolver(flat, objective, dtype=dt, device="cuda", dense=dense),
            DENSE_ITERS))
    if solves["float32"][1] != solves["float32 rerun"][1] or not all(
            torch.equal(a, b) for a, b in zip(solves["float32"][0].state,
                                              solves["float32 rerun"][0].state)):
        fail(f"gm50k dense float32 reruns differ: {solves['float32'][1]!r} vs "
             f"{solves['float32 rerun'][1]!r}")
    host64 = layout.flatten_uniform(pre.collection, V, npv, dtype=torch.float64, device="cuda")
    for name, host in (("float32", host32), ("float64", host64)):
        s, lb, its = solves[name]
        _, ref, ref_its = timed_solve(lambda: UniformSolver(host, objective), DENSE_ITERS)
        rel = abs(lb - ref) / abs(ref)
        print(f"[dense] gm50k {name}: lb {lb!r} after {DENSE_ITERS} iterations vs the uniform "
              f"solver on the same Python build {ref!r}: rel diff {rel:.3e} (limit "
              f"{DENSE_REL[name]}); {its:.2f} it/s ({1e3 / its:.2f} ms an iteration) against the "
              f"uniform path's {ref_its:.1f} it/s on the same build {card}", flush=True)
        if not rel <= DENSE_REL[name]:
            fail(f"gm50k dense {name} bound off the uniform solver's")
        out[f"gm50k {name}"] = {"lb": lb, "its_per_s": its, "uniform_lb": ref,
                                "uniform_its_per_s": ref_its}
    print(f"[dense] gm50k float32 rerun bit-identical: {solves['float32 rerun'][1]!r}; no sweep "
          f"kernel launched and no plain version called in the dense solves {card}", flush=True)
    out["profile"] = dense_guard("gm50k dense profile", lambda: profile_dense(
        "gm50k float32", solves["float32"][0], card))
    del solves, host64

    # ---- (b) grid12 float64: the card against the CPU
    grid = BddSolver({"precision": "double", "relaxation solver": "dense mma"},
                     device="cuda").read_ilp(ilp=grid_mrf(12, 12, 4, seed=0))
    grid.process_ilp().transform_to_bdds()
    gflat, gobj = grid.flat, grid.pre.objective_vector()
    gdense = densify(gflat)

    def grid_solver(dt=torch.float64, device="cuda"):
        return DenseSolver(gflat, gobj, dtype=dt, device=device, dense=gdense)

    card_s, card_lb, card_its = dense_guard("grid12 dense float64", lambda: timed_solve(
        grid_solver, DENSE_GRID_ITERS))
    t0 = time.perf_counter()
    cpu_s = grid_solver(device="cpu")
    cpu_s.iteration_block(DENSE_GRID_ITERS)
    cpu_lb = cpu_s.lower_bound_with_deferred()
    cpu_its = DENSE_GRID_ITERS / (time.perf_counter() - t0)
    rel = abs(card_lb - cpu_lb) / abs(cpu_lb)
    state_err = max(float(torch.nan_to_num(a.cpu() - b, nan=0.0, posinf=0.0, neginf=0.0)
                          .abs().max()) for a, b in zip(card_s.state, cpu_s.state))
    print(f"[dense] grid12 float64, H={gdense.H} W={gdense.W} L={gdense.L}: card lb {card_lb!r} vs "
          f"CPU {cpu_lb!r} after {DENSE_GRID_ITERS} iterations: rel diff {rel:.3e} (limit "
          f"1e-12), state max |diff| {state_err:.3e}; card {card_its:.2f} it/s, CPU "
          f"{cpu_its:.2f} it/s {card}", flush=True)
    if not rel <= 1e-12:
        fail("grid12 dense float64: card and CPU bounds differ")
    out["grid12 card vs cpu"] = {"rel": rel, "card_its_per_s": card_its, "cpu_its_per_s": cpu_its}

    # ---- (c) the API: "dense mma" with the default rounding, and with "tighten"
    ilp = grid_mrf(12, 12, 4, seed=0)
    api_cfg = {"relaxation solver": "dense mma",
               "termination criteria": {"maximum iterations": DENSE_API_ITERS}}

    def api_solve(cfg, ilp_):
        t = time.perf_counter()
        solver = BddSolver(cfg, device="cuda").read_ilp(ilp=ilp_)
        res = solver.solve(verbose=False)
        if not isinstance(solver.solver, DenseSolver):
            fail(f"dense mma built a {type(solver.solver).__name__}")
        return res, time.perf_counter() - t

    res, wall = dense_guard("grid12 dense mma through BddSolver", lambda: api_solve(api_cfg, ilp))
    checked_solution(ilp, res, "grid12 dense mma")
    lb, obj = res["lower_bound"], res["objective"]
    print(f"[dense] grid12 BddSolver('dense mma', default rounding, {DENSE_API_ITERS} dual "
          f"iterations) on the card: lb {lb!r}, objective {obj!r}, gap "
          f"{(obj - lb) / abs(obj):.4%}, feasible; {wall:.2f} s wall {card}", flush=True)
    dual_cfg = {"relaxation solver": "dense mma", **DUAL_ONLY,
                **fixed_iterations(DENSE_TIGHTEN_ITERS)}
    plain, _ = dense_guard("grid12 dense mma dual only", lambda: api_solve(
        dual_cfg, grid_mrf(12, 12, 4, seed=0)))
    tight, _ = dense_guard("grid12 dense mma with tighten", lambda: api_solve(
        {**dual_cfg, "tighten": True}, grid_mrf(12, 12, 4, seed=0)))
    if tight["lower_bound"] != plain["lower_bound"] or "tighten" in tight:
        fail(f"dense mma with tighten: lb {tight['lower_bound']!r} vs {plain['lower_bound']!r} "
             f"without; the phase must be skipped")
    print(f"[dense] grid12 'dense mma' with 'tighten': skipped (no layer costs), bound kept "
          f"{tight['lower_bound']!r} {card}", flush=True)
    out["api"] = {"lb": lb, "objective": obj, "wall_s": wall}

    # ---- (d) the outer loops over the dense base, grid12 float64
    outer = {}
    for name, wrap in (("lbfgs", LbfgsSolver), ("subgradient", SubgradientSolver),
                       ("plain dense MMA", None)):
        def run():
            solver = grid_solver() if wrap is None else wrap(grid_solver())
            torch.cuda.synchronize()
            t = time.perf_counter()
            if wrap is None:
                solver.iteration_block(DENSE_OUTER_ITERS)
            else:
                for _ in range(DENSE_OUTER_ITERS):
                    solver.iteration()
            torch.cuda.synchronize()
            return (float(solver.lower_bound_with_deferred()),
                    1e3 * (time.perf_counter() - t) / DENSE_OUTER_ITERS)

        outer[name] = dense_guard(f"grid12 dense {name}", run)
    (lb_l, ms_l), (lb_s, ms_s), (lb_m, ms_m) = (outer[k] for k in (
        "lbfgs", "subgradient", "plain dense MMA"))
    if not (math.isfinite(lb_s) and lb_l >= lb_m - 1e-3 * abs(lb_m)):
        fail(f"grid12 dense outer loops: lbfgs {lb_l!r}, subgradient {lb_s!r}, MMA {lb_m!r}")
    print(f"[dense] grid12 float64 after {DENSE_OUTER_ITERS} outer iterations over DenseSolver: "
          f"lbfgs {lb_l!r} ({ms_l:.2f} ms an outer iteration), subgradient {lb_s!r} "
          f"({ms_s:.2f} ms), plain dense MMA {lb_m!r} ({ms_m:.2f} ms an iteration) {card}",
          flush=True)
    out["outer"] = outer

    # ---- (e) the prefix sweeps on phase 2's unpacked gm50k layouts
    for name, host in gm_prefix.items():
        dt = host.geom.dtype
        sol = UniformSolver(host, gm_objective)
        sol.iteration_block(DENSE_PREFIX_ITERS)
        geom, st = sol.geom, sol.state
        lo, hi = st.flat[0], st.flat[1]
        run_cft = geom.per_bucket_nodes(uf.backward_run(geom, lo, hi))
        lb_run = float(uf.lower_bound_from_cft(geom, run_cft))
        lb_px = float(px.lower_bound_prefix(geom, st))
        tol = 1e-9 if dt == torch.float64 else 1e-5 * max(1.0, abs(lb_run))
        if not abs(lb_px - lb_run) <= tol:
            fail(f"gm50k {name}: lower_bound_prefix {lb_px!r} vs the run entry's {lb_run!r}")
        mm = uf.min_marginals_all(geom, st, cft=run_cft)
        errs_px = [0.0, 0.0, 0.0]
        for g, l, h, c, (m0, m1) in zip(geom.buckets, st.lo, st.hi, run_cft, mm):
            errs_px[0] = max(errs_px[0], close_runs(
                f"gm50k {name} backward prefix", px.bucket_backward_run_prefix(g, l, h), c, dt))
            errs_px[1] = max(errs_px[1], close_runs(
                f"gm50k {name} forward prefix", px.bucket_forward_run_prefix(g, l, h),
                uf.bucket_forward_run(g, l, h), dt))
            for a, b in zip(px.bucket_min_marginals_prefix(g, l, h), (m0, m1)):
                errs_px[2] = max(errs_px[2], close_runs(f"gm50k {name} prefix marginals", a, b, dt))

        def each(fn):
            return lambda: [fn(g, l, h) for g, l, h in zip(geom.buckets, st.lo, st.hi)]

        ms = {"lower_bound_prefix": cuda_ms(lambda: px.lower_bound_prefix(geom, st), 5),
              "backward run entry (kernel)": cuda_ms(lambda: uf.backward_run(geom, lo, hi), 20),
              "bucket_backward_run_prefix": cuda_ms(each(px.bucket_backward_run_prefix), 5),
              "bucket_forward_run_prefix": cuda_ms(each(px.bucket_forward_run_prefix), 5),
              "plain bucket_forward_run": cuda_ms(each(uf.bucket_forward_run), 3),
              "bucket_min_marginals_prefix": cuda_ms(each(px.bucket_min_marginals_prefix), 5),
              "min_marginals_all": cuda_ms(lambda: uf.min_marginals_all(geom, st, cft=run_cft), 3)}
        print(f"[dense] prefix sweeps on gm50k unpacked {name} "
              f"{[(g.P, g.H, g.B) for g in geom.buckets]} after {DENSE_PREFIX_ITERS} iterations: "
              f"lower_bound_prefix {lb_px!r} vs the run entry's {lb_run!r}; backward, forward and "
              f"min-marginal prefix sweeps match the run entry, the plain forward run and "
              f"min_marginals_all (max |diff| {errs_px}); ms over all buckets "
              f"{ {k: round(v, 4) for k, v in ms.items()} } {card}", flush=True)
        out[f"prefix {name}"] = {"lb": lb_px, "run_lb": lb_run, "ms": ms}

    # ---- (f) a checkpoint on the card, resumed bit for bit
    def checkpoint():
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "dense.pkl")
            a = grid_solver(torch.float32)
            a.iteration_block(10)
            extras.save_state(a, path)
            b = grid_solver(torch.float32)
            extras.load_state(b, path)
        a.iteration_block(10)
        b.iteration_block(10)
        if not all(torch.equal(x, y) for x, y in zip(a.state, b.state)) or (
                a.lower_bound_with_deferred() != b.lower_bound_with_deferred()):
            fail("dense checkpoint: the next 10 iterations differ from the uninterrupted run")
        return a.lower_bound_with_deferred()

    lb_ck = dense_guard("grid12 dense checkpoint", checkpoint)
    print(f"[dense] grid12 float32 checkpoint saved and loaded on the card: the next 10 "
          f"iterations equal the uninterrupted run bit for bit (lb {lb_ck!r}) {card}", flush=True)
    return out


def sharded_dense(rank, collection, V, obj, card) -> dict:
    """Phase 15's dense part on this rank: the dense ``ShardedSolver`` over
    the gm50k collection, float32 and float64 (the float64 solver takes the
    float32 one's shards), DENSE_SHARDED_ITERS iterations each, one
    all_reduce of the [V + 1, 2] delta pair timed (the one-device reference
    is :func:`dense_reference`, in the parent)."""
    import torch
    from bdd_tpu_torch.solver.sharding import ShardedSolver

    out, like = {}, None
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        t0 = time.perf_counter()
        s = ShardedSolver(collection, V, obj, dtype=dt, like=like)
        build_s = time.perf_counter() - t0
        like = s.sharded

        def solve():
            s.comm.calls = 0
            torch.cuda.synchronize()
            s.comm.barrier()
            t = time.perf_counter()
            s.iteration_block(DENSE_SHARDED_ITERS)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        wall = dense_guard(f"dense sharded {name}", solve)
        calls = s.comm.calls
        lb = s.lower_bound()
        pair_ms = collective_ms(s.comm, torch.zeros(V + 1, 2, dtype=dt, device=s.device), 10)
        g = s.geom
        out[name] = {"lb": lb, "ms_per_iteration": 1e3 * wall / DENSE_SHARDED_ITERS,
                     "all_reduce_ms": pair_ms, "build_s": build_s,
                     "collectives_per_iteration": calls / DENSE_SHARDED_ITERS}
        print(f"[sharded] dense {name} rank {rank}: {len(s.sharded.parts[rank])} BDDs, shard "
              f"H={g.H} W={g.W} L={g.L}, built in {build_s:.2f} s; lb {lb!r} after "
              f"{DENSE_SHARDED_ITERS} iterations, {out[name]['ms_per_iteration']:.2f} ms an "
              f"iteration, {out[name]['collectives_per_iteration']:.2f} all_reduce an iteration, "
              f"one all_reduce of the [V + 1, 2] pair {pair_ms:.4f} ms {card}", flush=True)
    s.comm.barrier()
    return out


# ------------------------------------------------ the huge body's split
# ``python3 chip_smoke.py --huge-split``: variants of the sweep kernels timed
# side by side. Each is a copy of ``csrc/uniform_sweep.cu`` with a few lines
# replaced, built with the library's own flags and ``-Xptxas -v`` into
# ``bdd_tpu_torch/build/variants/`` (all copies side by side) and loaded in
# place of the library. A replacement whose text is no longer in the source
# stops the run and names it. The runs of the L2 body (a plan built on it,
# ``variant_plan``'s ``body="huge_l2"``; at knapsack48's 132 columns the plan's G is
# 1, so both are the form of one block a column):
#   l2            as the plan gives it;
#   l2_one_block  G = 1 forced (``l2_split=1``);
# the variant of the L2 body's hop barrier (run by the "barrier" part, where
# the plan splits a column):
#   l2_fenced     __threadfence before the arrival and after the wait;
# and the variants of the shared-memory body (the plan's):
#   smem          as it is;
#   smem_one_row  the backward on one row where the plan gives it two;
#   smem_single   every slot loop a slot at a time;
#   smem_run_grouped  the run's slot loop in groups of HUGE_GROUP loads too;
#   smem_backward_by_width  the backward in groups only where a thread has
#                 HUGE_GROUP slots (a one-slot form compiled beside it);
#   smem_prefetch the next hop's arc record (and the cft row the forward
#                 gathers, or the backward's cfr row) prefetched to L2;
#   staged        the forward's cft row of hop h+1 copied into shared memory a
#                 hop ahead (cp.async by every thread, a ring of two rows)
#                 instead of gathered through L1; only where two blocks an SM
#                 still fit with it, so at the crossover rows, not knapsack48.
_GROUPED = "  const bool grouped = FORWARD ? P >= G * nt : !RUN;\n"
_PREFETCH_HELPERS = (
    "// min of (m0, m1) over the block, in every thread, with one barrier: each",
    "__device__ __forceinline__ void prefetch_l2(const void* p) {\n"
    "  asm volatile(\"prefetch.L2 [%0];\" ::\"l\"(p));\n"
    "}\n"
    "__device__ __forceinline__ void block_prefetch(const void* g, size_t bytes) {\n"
    "  const unsigned char* c = (const unsigned char*)g;\n"
    "  for (size_t off = (size_t)threadIdx.x * 128; off < bytes;\n"
    "       off += (size_t)blockDim.x * 128)\n"
    "    prefetch_l2(c + off);\n"
    "}\n"
    "// min of (m0, m1) over the block, in every thread, with one barrier: each")
SPLIT_PATCHES = {
    "l2_fenced": [("      red_release_add(counter, 1u);\n"
                   "      while (ld_acquire(counter) < passed) {\n"
                   "      }\n",
                   "      __threadfence();\n"
                   "      red_release_add(counter, 1u);\n"
                   "      while (ld_acquire(counter) < passed) {\n"
                   "      }\n"
                   "      __threadfence();\n")],
    "smem_one_row": [("  const bool two_rows = !FORWARD && bk.stages == 2;\n",
                      "  const bool two_rows = false;\n")],
    "smem_single": [(_GROUPED, "  const bool grouped = false;\n")],
    "smem_run_grouped": [(_GROUPED, "  const bool grouped = FORWARD ? P >= G * nt : true;\n")],
    "smem_backward_by_width": [(_GROUPED, "  const bool grouped = !RUN && P >= G * nt;\n")],
    "smem_prefetch": [
        _PREFETCH_HELPERS,
        ("    if (i + 1 < H) start_copies(FORWARD ? h + 1 : h - 1, ring + ((i + 1) & 1) * slot_bytes);\n",
         "    if (i + 1 < H) {\n"
         "      const int hn = FORWARD ? h + 1 : h - 1;\n"
         "      start_copies(hn, ring + ((i + 1) & 1) * slot_bytes);\n"
         "      block_prefetch(g_arcs + ((size_t)hn * B + b) * 2 * P, (size_t)2 * P * sizeof(W));\n"
         "      if (FORWARD && hn + 1 < H)\n"
         "        block_prefetch(g_front + ((size_t)(hn + 1) * B + b) * P, (size_t)P * SZ);\n"
         "      if (!FORWARD && !RUN)\n"
         "        block_prefetch(g_front + ((size_t)hn * B + b) * P, (size_t)P * SZ);\n"
         "    }\n"),
    ],
    "staged": [
        ("  const int slot_bytes = HUGE_SCALARS * SZ;\n",
         "  const int slot_bytes = HUGE_SCALARS * SZ + (FORWARD ? row_bytes : 0);\n"),
        ("      cp_async<SZ>(slot + t * SZ, src + e);\n    }\n  };\n",
         "      cp_async<SZ>(slot + t * SZ, src + e);\n    }\n"
         "    if (FORWARD && h + 1 < H) {  // cft of hop h+1 into the slot's row\n"
         "      const unsigned char* g =\n"
         "          (const unsigned char*)(g_front + ((size_t)(h + 1) * B + b) * P);\n"
         "      unsigned char* dst = slot + HUGE_SCALARS * SZ;\n"
         "      if ((P * SZ) % 16 == 0)\n"
         "        for (int c = t * 16; c < P * SZ; c += nt * 16) cp_async<16>(dst + c, g + c);\n"
         "      else\n"
         "        for (int c = t * SZ; c < P * SZ; c += nt * SZ) cp_async<SZ>(dst + c, g + c);\n"
         "    }\n  };\n"),
        ("      const T* cft_g = g_front + (col + (size_t)B) * P;  // cft of hop h+1\n",
         "      const T* cft_g = (const T*)(slot + HUGE_SCALARS * SZ);  // staged\n"),
        ("      tl[u] = child_cost<T, false>(c[u] & 0x7fffu, 0u, cft_g, has);\n"
         "      th[u] = child_cost<T, false>(c[u] >> 16, 0u, cft_g, has);\n",
         "      tl[u] = child_cost<T, true>(c[u] & 0x7fffu, smem_addr(cft_g), nullptr, has);\n"
         "      th[u] = child_cost<T, true>(c[u] >> 16, smem_addr(cft_g), nullptr, has);\n"),
    ],
}
# (variant, library, plan keywords, the layouts it runs on)
SPLIT_RUNS = [("l2", None, {"body": "huge_l2"}, ("knapsack48",)),
              ("l2_one_block", None, {"body": "huge_l2", "l2_split": 1}, ("knapsack48",)),
              ("smem", None, {}, ("knapsack48", "crossover")),
              ("smem_one_row", "smem_one_row", {}, ("knapsack48",)),
              ("smem_single", "smem_single", {}, ("knapsack48",)),
              ("smem_run_grouped", "smem_run_grouped", {}, ("knapsack48",)),
              ("smem_backward_by_width", "smem_backward_by_width", {}, ("knapsack48",)),
              ("smem_prefetch", "smem_prefetch", {}, ("knapsack48",)),
              ("staged", "staged", {}, ("crossover",))]
SPLIT_CROSSOVER_P = (1024, 4096)  # crossover rows (132 over 256 columns) where staging fits
# the crossover at more columns: (P, rows, coefficients up to); rows pad to
# a multiple of 128 columns (at 100, two of 2,000 rows stay within 512 slots)
SPLIT_COLUMNS = [(1024, 512, 110), (1024, 1024, 110), (1024, 2000, 110), (2048, 1024, 250),
                 (2048, 2000, 250), (4096, 2000, 500)]


def split_source(name: str) -> str:
    """The kernel source with the replacements of variant ``name``."""
    from bdd_tpu_torch import _build

    with open(_build.SOURCE) as fh:
        src = fh.read()
    for old, new in SPLIT_PATCHES[name]:
        if old not in src:
            fail(f"{name}: the text {old[:60]!r} is not in the source")
        src = src.replace(old, new)
    return src


def split_build(names=None) -> dict:
    """Compile the kernel source and the variants ``names`` (every one of
    SPLIT_PATCHES where none is named) side by side (``-Xptxas -v``); name ->
    (library path, ptxas report)."""
    from bdd_tpu_torch import _build

    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build.nvcc_path()
    jobs = {}
    for name in [None] + list(SPLIT_PATCHES if names is None else names):
        stem = name or "repo"
        src = _build.SOURCE
        if name:
            src = os.path.join(out_dir, f"{stem}.cu")
            with open(src, "w") as fh:
                fh.write(split_source(name))
        lib = os.path.join(out_dir, f"lib{stem}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, src]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            fail(f"nvcc failed for variant {name or 'repo'}:\n{report[-4000:]}")
        built[name] = (lib, report)
    return built


def split_ptxas(report: str):
    """(kernel, registers, spill stores, stack frame) of the huge kernels."""
    rows, name = [], None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S*(sweep_huge\w*_kernelI[fd]Li\dE[jy]?))", line)
        if m:
            name = m.group(2)
            continue
        if name and "stack frame" in line:
            frame = int(re.search(r"(\d+) bytes stack frame", line).group(1))
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            rows.append([name, None, spill, frame])
        elif name and "Used" in line and rows and rows[-1][0] == name:
            rows[-1][1] = int(re.search(r"Used (\d+) registers", line).group(1))
            name = None
    return rows


# knapsack rows of 24, 32, 40 and 48 variables whose coefficients (up to the
# second number) make BDDs of 1,024 slots, 500 rows of each: four float32
# buckets that the route sends to the huge body one by one (512 columns, at
# most 4 an SM), 2,048 columns in one table
ROUTE_ROWS = ((24, 180), (32, 100), (40, 80), (48, 70))
ROUTE_NR_ROWS = 500
# (C, threads a block) of the cluster body timed on knapsack48's L2 rows
# beside the plan's own (None: the plan's threads for that C)
CLUSTER_SWEEP = [(2, None), (2, 512), (4, None), (4, 1024), (8, None), (8, 512), (16, None),
                 (16, 1024)]
# the cluster sizes timed on the 65,536-slot rows (eight-byte slot codes), at
# 8 columns (phase 6's rows) and at 132 (here only: their host build is too
# slow for phase 6); a size whose block does not hold its share is named
CLUSTER_WIDE_SWEEP = [(2, None), (4, None), (8, None), (8, 512), (16, None), (16, 512)]
# the row of 262,144 slots: only a cluster of 16 holds it (float32)
CLUSTER_WIDEST_SWEEP = [(16, None)]
L2_WIDE_ROWS_132 = dict(nr_vars=1584, nr_rows=132, row_len=48, coef_max=4000)
SPLIT_PARTS = ("variants", "columns", "table", "route", "cluster", "barrier")
# the L2 body's hop barriers alone: a bucket of BARRIER_P slots whose layers
# hold no node, BARRIER_H hops, over 1 and 2 columns
BARRIER_P, BARRIER_H = 262144, 48


SPLIT_CHUNK = 1 << 28  # values a comparison of split_times takes at once


def split_state(host, objective):
    """(lo, hi, cft, din_lo, din_hi) after five twin iterations, and the
    plain versions' forward, backward and run outputs from them."""
    from bdd_tpu_torch.solver import uniform as uf

    geom = host.geom
    st = uf.iterations(geom, uf.init_uniform_state(host, objective), 5, sweeps=uf.TWIN_SWEEPS)
    lo, hi, mm, cft = st.flat
    dl, dh = uf.exchange_delta_flat(geom, mm)
    ref_f = uf.sweep_per_bucket(uf.bucket_forward_iteration, geom, lo, hi, cft, 0.5, dl, dh)
    ref_b = uf.sweep_per_bucket(uf.bucket_backward_iteration, geom, ref_f[0], ref_f[1], ref_f[3],
                                0.5, dl, dh)
    ref_r = geom.flatten_nodes([uf.bucket_backward_run(g, a, b) for g, a, b in zip(
        geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))])
    return (lo, hi, cft, dl, dh), {"uniform_forward": ref_f, "uniform_backward": ref_b, RUN: [ref_r]}


def split_times(geom, state, refs, plan, flush, reps=100) -> dict:
    """kernel -> (warm, cold ms) of the three launches of ``plan`` over
    ``geom`` from ``state``, each held to the plain versions bit for bit.
    One launch's outputs at a time, compared in chunks of SPLIT_CHUNK values,
    so that layouts of tens of GB leave room for the comparison."""
    import torch
    from bdd_tpu_torch.solver import sweep_kernels as sk

    lo, hi, cft, dl, dh = state
    ref_f = refs["uniform_forward"]
    out = {}
    for kernel in ("uniform_forward", "uniform_backward", RUN):
        if kernel == RUN:
            launch, res = sk.prepare_run_launch(geom, lo, hi, plan)
            res = [res]
        else:
            a, b, c = (lo, hi, cft) if kernel == "uniform_forward" else (
                ref_f[0], ref_f[1], ref_f[3])
            launch, res = sk.prepare_fused_launch(kernel, geom, a, b, c, 0.5, dl, dh, plan)
        launch()
        torch.cuda.synchronize()
        if [x.shape for x in res] != [y.shape for y in refs[kernel]]:
            fail(f"{kernel}: outputs {[tuple(x.shape) for x in res]} vs the plain version's "
                 f"{[tuple(y.shape) for y in refs[kernel]]}")
        compare(*([c for x in xs for c in x.reshape(-1).split(SPLIT_CHUNK)]
                  for xs in (res, refs[kernel])), 0.0)
        out[kernel] = (cuda_ms(launch, reps), cuda_ms(launch, max(1, reps // 10), flush))
        del launch, res
    return out


def split_bounds(geom, itemsize: int) -> dict:
    shapes = bdd_shapes(geom.buckets)
    return {k: 1e3 * v / HBM_BYTES_PER_S for k, v in (
        ("uniform_forward", launch_bytes(shapes, itemsize, True)),
        ("uniform_backward", launch_bytes(shapes, itemsize, False)),
        (RUN, run_bytes(shapes, itemsize)))}


def split_row(times: dict, bounds: dict) -> str:
    return "; ".join(f"{k} warm {w:.4f} ms ({share(bounds[k], w)}), cold {c:.4f} ms"
                     for k, (w, c) in times.items())


def split_table(card, flush) -> None:
    """The route's float32 rule on a whole huge table: layouts whose float32
    buckets below HUGE_FROM_F32_MANY the route once sent to the huge body one
    by one, timed as the plan runs them now (the wide body) and as they ran
    before (a plan built on the huge body: every one in the huge table, at
    the threads its columns leave a block). ROUTE_ROWS over 2,048 columns; and
    200 rows of 1,024 slots beside knapsack48's in one layout."""
    import torch
    from bdd_tpu_torch.native import NativeHost
    from bdd_tpu_torch.solver import layout

    lps = [knapsack_lp(nr_vars=10 * n, nr_rows=ROUTE_NR_ROWS, row_len=n, coef_max=c)
           for n, c in ROUTE_ROWS]
    beside = merged_lp(knapsack_lp(nr_vars=320, nr_rows=200, row_len=32, coef_max=100),
                       knapsack_lp(**HUGE_ROWS))
    for label, lp in (("four 1,024-slot families", merged_lp(*lps)),
                      ("1,024 slots beside knapsack48", beside)):
        t0 = time.perf_counter()
        nh = NativeHost(lp, "input")
        host = layout.from_native_host(nh, torch.float32, "cuda", pack=False)
        geom = host.geom
        state, refs = split_state(host, nh.objective())
        now = geom.plan
        before = variant_plan(now.shapes, torch.float32, "cuda", "huge")
        bounds = split_bounds(geom, 4)
        print(f"[split] route {label} float32: buckets {[tuple(x) for x in now.shapes]}, built in "
              f"{time.perf_counter() - t0:.1f} s; now {plan_text(now)}; before "
              f"{plan_text(before)} {card}", flush=True)
        for name, plan in (("before", before), ("now", now), ("now", now), ("before", before)):
            print(f"[split] route {label} float32 {name}: match; "
                  f"{split_row(split_times(geom, state, refs, plan, flush), bounds)} {card}",
                  flush=True)
        del host, geom, state, refs
        torch.cuda.empty_cache()


def route_rows(columns: int, coef_max: int) -> dict:
    """``knapsack_lp``'s arguments for ``columns`` rows of 48 variables with
    coefficients up to ``coef_max`` (2,000 / 4,000 / 8,000 / 16,000 make
    BDDs of 32,768 / 65,536 / 131,072 / 262,144 slots), over as many
    variables as whole permutations allow."""
    nr_vars = 1584 if columns % 33 == 0 else 96 if columns % 2 == 0 else 48
    return dict(nr_vars=nr_vars, nr_rows=columns, row_len=48, coef_max=coef_max)


# the layouts of --huge-split route: (slots, columns, coefficients up to, the
# precisions a cluster holds the rows in); 262,144 slots only C = 16 holds,
# and only in float32, 131,072 in float64 only C = 16 (the widest of them,
# 132 columns, about 27 / 20 GB to solve)
ROUTE_LAYOUTS = ([(65536, c, 4000, ("float32", "float64")) for c in (1, 8, 16)]
                 + [(262144, c, 16000, ("float32",)) for c in (1, 8)]
                 + [(131072, c, 8000, ("float64",)) for c in (1, 8)]
                 + [(32768, c, 2000, ("float32", "float64")) for c in (8, 33, 66, 132)]
                 + [(65536, c, 4000, ("float32", "float64")) for c in (33, 66, 132)]
                 + [(262144, c, 16000, ("float32",)) for c in (33, 66, 132)]
                 + [(131072, c, 8000, ("float64",)) for c in (33, 66, 132)])
# rows past WIDE_P that a block holds: knapsack48's rows of 16,384 slots in
# both precisions, and the same rows padded with empty slots to the widest a
# block holds, 29,016 in float32 and 19,316 in float64 (no layout builds such
# a bucket: widths are powers of two); the shared-memory huge body, the L2 body
# and the cluster body forced in turns. What the route of such rows rests on.
BLOCK_ROUTE_LAYOUTS = [(P, c, 1000, dts) for c in (1, 5, 7, 8, 16, 33, 66, 132)
                       for P, dts in ((16384, ("float32", "float64")), (29016, ("float32",)),
                                      (19316, ("float64",)))]


def padded_host(nh, P: int, dtype):
    """The layout of ``nh``'s BDDs, unpacked, with every bucket widened to P
    slots by slots that hold no node (the records of a width no layout
    builds, whose rows still reach every slot of the bucket)."""
    import numpy as np
    from bdd_tpu_torch.solver import layout

    buckets, counts = layout._native_buckets(nh)
    for b in buckets:
        H, width, B = b["node_valid"].shape
        more = ((0, 0), (0, P - width), (0, 0))
        b["node_valid"] = np.pad(b["node_valid"], more)
        for k, fill in (("lo_kind", layout.ARC_BOT), ("hi_kind", layout.ARC_BOT),
                        ("lo_slot", 0), ("hi_slot", 0)):
            b[k] = np.pad(b[k], more, constant_values=fill)
    V = nh.nr_vars()
    return layout._build_host(buckets, counts, V, V, nh.nr_bdds(), dtype, "cuda")


def split_route(card, flush, widths=()) -> None:
    """The bodies past WIDE_P against each other on the layouts of
    ROUTE_LAYOUTS and BLOCK_ROUTE_LAYOUTS (knapsack rows, H = 48, unpacked),
    where ``widths`` names any ((P,) or (P, columns)) those alone: each forced
    in turns, the cluster body at the plan's cluster size and the L2 body at
    the plan's blocks a column G for its table (cluster, L2, L2, cluster;
    where a block holds the rows the shared-memory huge body first and last:
    huge, L2, cluster, cluster, L2, huge), every launch held to the plain
    versions bit for bit; the route's own choice beside them. What
    ``layout.L2_FROM_SPLIT``, ``layout.BLOCK_ROWS_CLUSTER`` and
    ``layout.CLUSTER_SIZES`` rest on."""
    import torch
    from bdd_tpu_torch.native import NativeHost
    from bdd_tpu_torch.solver import layout

    rows = nh = None  # the rows last built, kept for the next layout of the same rows
    for P, columns, coef_max, precisions in ROUTE_LAYOUTS + BLOCK_ROUTE_LAYOUTS:
        if widths and not {(P,), (P, columns)} & set(widths):
            continue
        if rows != (columns, coef_max):
            rows, nh = (columns, coef_max), None
            t0 = time.perf_counter()
            nh = NativeHost(knapsack_lp(**route_rows(columns, coef_max)), "input")
            print(f"[split] route x{columns} (coefficients up to {coef_max}): {nh.nr_bdds()} "
                  f"BDDs built in {time.perf_counter() - t0:.1f} s {card}", flush=True)
        for dt in precisions:
            dtype = getattr(torch, dt)
            itemsize = torch.empty((), dtype=dtype).element_size()
            # a layout's widths are powers of two; the others are padded rows
            host = (layout.from_native_host(nh, dtype, "cuda", pack=False) if P & (P - 1) == 0
                    else padded_host(nh, P, dtype))
            geom = host.geom
            state, refs = split_state(host, nh.objective())
            bounds = split_bounds(geom, itemsize)
            shapes = geom.plan.shapes
            cluster = variant_plan(shapes, dtype, "cuda", "huge_cluster")
            l2 = variant_plan(shapes, dtype, "cuda", "huge_l2")
            print(f"[split] route P={P} x{columns} {dt}: buckets {[tuple(x) for x in shapes]}, "
                  f"{layout.solve_bytes(shapes, itemsize)} B to solve; cluster "
                  f"{plan_text(cluster)}; L2 {plan_text(l2)}; the route: "
                  f"{plan_text(geom.plan)} {card}", flush=True)
            reps = 100 if columns <= 16 else 40
            turns = (("cluster", cluster), ("L2", l2), ("L2", l2), ("cluster", cluster))
            if not buckets_of(cluster, HUGE_CLUSTER):  # no cluster size holds these rows
                turns = turns[1:2]
            if layout.huge_fits(P, itemsize):
                huge = variant_plan(shapes, dtype, "cuda", "huge")
                turns = (("huge", huge), ("L2", l2), ("cluster", cluster), ("cluster", cluster),
                         ("L2", l2), ("huge", huge))
            for name, plan in turns:
                print(f"[split] route P={P} x{columns} {dt} {name}: match; "
                      f"{split_row(split_times(geom, state, refs, plan, flush, reps), bounds)} "
                      f"{card}", flush=True)
            del host, geom, state, refs
            torch.cuda.empty_cache()


def split_cluster(card, flush) -> None:
    """The cluster body on knapsack48's L2 rows (P = 32,768 over 132
    columns), on rows of 65,536 slots over 8 and over 132 columns and on
    the row of 262,144 slots, both precisions: every (C, threads) of
    CLUSTER_SWEEP / CLUSTER_WIDE_SWEEP / CLUSTER_WIDEST_SWEEP, the card's
    answer for the clusters it holds at once, and the L2 body beside them,
    at the plan's blocks a column and at one, each held to the plain
    versions bit for bit."""
    import torch
    from bdd_tpu_torch.native import NativeHost
    from bdd_tpu_torch.solver import layout

    for label, rows, sweep in (("knapsack48 L2", L2_ROWS, CLUSTER_SWEEP),
                               ("knapsack L2 wide", L2_WIDE_ROWS, CLUSTER_WIDE_SWEEP),
                               ("knapsack L2 wide x132", L2_WIDE_ROWS_132, CLUSTER_WIDE_SWEEP),
                               ("knapsack L2 widest", L2_WIDEST_ROWS, CLUSTER_WIDEST_SWEEP)):
        t0 = time.perf_counter()
        nh = NativeHost(knapsack_lp(**rows), "input")
        print(f"[split] cluster {label}: {nh.nr_bdds()} BDDs built in "
              f"{time.perf_counter() - t0:.1f} s {card}", flush=True)
        for dtype in (torch.float32, torch.float64):
            itemsize = torch.empty((), dtype=dtype).element_size()
            dt = str(dtype).replace("torch.", "")
            host = layout.from_native_host(nh, dtype, "cuda", pack=False)
            geom = host.geom
            state, refs = split_state(host, nh.objective())
            bounds = split_bounds(geom, itemsize)
            plan = geom.plan
            print(f"[split] cluster {label} {dt}: buckets {[tuple(x) for x in plan.shapes]}; the "
                  f"plan: {plan_text(plan)} {card}", flush=True)
            for split in (None, 1):
                l2 = variant_plan(plan.shapes, dtype, "cuda", "huge_l2", l2_split=split)
                G, _ = launch_of(l2, HUGE_L2).own
                reps = 100 if G > 1 or plan.shapes[0][0] < 262144 else 20
                print(f"[split] cluster {label} {dt} L2 body, {G} blocks a column "
                      f"({blocks_of(l2, HUGE_L2)} blocks): match; "
                      f"{split_row(split_times(geom, state, refs, l2, flush, reps), bounds)} "
                      f"{card}", flush=True)
                if G == 1:
                    break
            for C, threads in sweep:
                try:
                    forced = variant_plan(plan.shapes, dtype, "cuda", "huge_cluster",
                                          threads or None, cluster_size=C)
                except ValueError as exc:  # its share does not fit a block
                    print(f"[split] cluster {label} {dt} C={C}: {exc} {card}", flush=True)
                    continue
                cl = launch_of(forced, HUGE_CLUSTER)
                active = layout.cluster_occupancy(itemsize, C, cl.threads, cl.smem_forward,
                                                  "cuda", 0, cl.own[1])
                print(f"[split] cluster {label} {dt} C={C} {cl.threads} threads "
                      f"({active} clusters at once, rows "
                      f"{[int(r[7]) for r in cl.table.tolist()]}, "
                      f"{cl.smem_forward} / {cl.smem_backward} B): match; "
                      f"{split_row(split_times(geom, state, refs, forced, flush), bounds)} "
                      f"{card}", flush=True)
            del host, geom, state, refs
            torch.cuda.empty_cache()


def split_barrier(card, flush) -> None:
    """What the L2 body's hop barriers cost alone: a float64 bucket of
    BARRIER_P slots whose layers hold no node past the root (a hop reads its
    record, takes no gather and no atomic, and passes its barriers: two a
    forward and a backward hop, one a run's), BARRIER_H hops over 1 and 2
    columns, at the plan's blocks a column and at one, held to the plain
    versions; the ms a hop of each entry. At the plan's blocks a column also
    the variant ``l2_fenced`` beside the source's, in turns (source, fenced,
    fenced, source)."""
    import ctypes

    import numpy as np
    import torch
    from bdd_tpu_torch import _build
    from bdd_tpu_torch.solver import layout

    libs = {}
    for name, (path, _) in split_build(["l2_fenced"]).items():
        libs[name] = ctypes.CDLL(path)
        _build._declare(libs[name])

    P, H = BARRIER_P, BARRIER_H
    for B in (1, 2):
        zeros = np.zeros((H, P, B), dtype=np.int32)
        node_valid = zeros.astype(bool)
        node_valid[0, 0] = True  # the root, both arcs to the terminal: no node past hop 0
        top = zeros.copy()
        top[0, 0] = layout.ARC_TOP
        bucket = dict(
            node_valid=node_valid, lo_kind=top, lo_slot=zeros, hi_kind=top,
            hi_slot=zeros, layer_valid=np.ones((H, B), bool),
            layer_var=np.zeros((H, B), np.int32), alpha=np.full((H, B), 0.5),
            layer_bdd=np.zeros((H, B), np.int64), root_mask=None,
            bdd_of_col=np.arange(B, dtype=np.int64), depths=np.full(B, H, dtype=np.int32))
        host = layout._build_host([bucket], np.full(1, B, np.int64), 1, 1, B, torch.float64,
                                  "cuda")
        geom = host.geom
        state, refs = split_state(host, np.ones(1))
        for split, lib in ((None, None), (None, "l2_fenced"), (None, "l2_fenced"), (None, None),
                           (1, None)):
            _build._LIB = libs[lib]
            plan = variant_plan(geom.plan.shapes, torch.float64, "cuda", l2_split=split)
            G, _ = launch_of(plan, HUGE_L2).own
            times = split_times(geom, state, refs, plan, flush, 100 if G > 1 else 20)
            print(f"[split] barrier P={P} H={H} B={B} float64 {lib or 'source'}, {G} "
                  f"blocks a column ({blocks_of(plan, HUGE_L2)} blocks), no node past the root: "
                  f"match; "
                  + "; ".join(f"{k} warm {w:.4f} ms ({1e3 * w / H:.2f} us a hop), cold {c:.4f} ms"
                              for k, (w, c) in times.items()) + f" {card}", flush=True)
        _build._LIB = None
        del host, geom, state, refs
        torch.cuda.empty_cache()


def huge_split(parts=()) -> None:
    """``parts`` of SPLIT_PARTS (all where none is named). "variants": every
    variant held to the twins bit for bit and timed warm and cold beside the
    byte bound, on knapsack48 (B = 132), both precisions, and, for the staged
    forward, on the crossover rows of SPLIT_CROSSOVER_P slots. "columns": the
    crossover between the wide and the huge body at more columns
    (SPLIT_COLUMNS), with the library as built; "table": :func:`split_table`;
    "route": :func:`split_route` ("route:262144,131072x66": those widths,
    the second over 66 columns alone); "cluster": :func:`split_cluster`;
    "barrier": :func:`split_barrier`."""
    import ctypes
    import torch
    from bdd_tpu_torch import _build
    from bdd_tpu_torch.native import NativeHost
    from bdd_tpu_torch.solver import layout
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf

    parts = tuple(parts) or SPLIT_PARTS
    # "route:W,WxC": the route part on rows of those widths alone (WxC: over
    # C columns alone)
    widths = [tuple(int(v) for v in w.split("x")) for p in parts if p.startswith("route:")
              for w in p[6:].split(",")]
    parts = tuple("route" if p.startswith("route:") else p for p in parts)
    if set(parts) - set(SPLIT_PARTS):
        fail(f"--huge-split takes parts of {SPLIT_PARTS}, not {parts}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the split needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"[{smi}]"
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    _build.load()
    if "table" in parts:
        split_table(card, flush)
    if "route" in parts:
        split_route(card, flush, widths)
    if "cluster" in parts:
        split_cluster(card, flush)
    if "barrier" in parts:
        split_barrier(card, flush)
    if "columns" in parts:
        for P, coef_max in CROSSOVER_ROWS.items():
            crossover_rows(P, 132, coef_max, card, flush)
        for P, nr_rows, coef_max in SPLIT_COLUMNS:
            crossover_rows(P, nr_rows, coef_max, card, flush)
    if "variants" not in parts:
        return
    t0 = time.perf_counter()
    built = split_build([n for n in SPLIT_PATCHES if n != "l2_fenced"])
    print(f"[split] built {len(built)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    libs = {}
    for name, (path, report) in built.items():
        for kern, regs, spill, frame in split_ptxas(report):
            print(f"[ptxas] {name or 'repo'} {kern}: {regs} registers, {spill} B spill stores, "
                  f"{frame} B stack frame", flush=True)
        libs[name] = ctypes.CDLL(path)
        _build._declare(libs[name])
    layouts = [("knapsack48", knapsack_lp(**HUGE_ROWS), "knapsack48")]
    layouts += [(f"knapsack{P}", knapsack_lp(nr_vars=1056, nr_rows=132, row_len=32,
                                             coef_max=CROSSOVER_ROWS[P]), "crossover")
                for P in SPLIT_CROSSOVER_P]
    for label, lp, kind in layouts:
        nh = NativeHost(lp, "input")
        for dtype in (torch.float32, torch.float64):
            host = layout.from_native_host(nh, dtype, "cuda", pack=False)
            geom = host.geom
            dt = str(dtype).replace("torch.", "")
            itemsize = torch.empty((), dtype=dtype).element_size()
            st = uf.iterations(geom, uf.init_uniform_state(host, nh.objective()), 5,
                               sweeps=uf.TWIN_SWEEPS)
            lo, hi, mm, cft = st.flat
            dl, dh = uf.exchange_delta_flat(geom, mm)
            ref_f = uf.sweep_per_bucket(uf.bucket_forward_iteration, geom, lo, hi, cft, 0.5, dl,
                                        dh)
            ref_b = uf.sweep_per_bucket(uf.bucket_backward_iteration, geom, ref_f[0], ref_f[1],
                                        ref_f[3], 0.5, dl, dh)
            ref_r = geom.flatten_nodes([uf.bucket_backward_run(g, a, b) for g, a, b in zip(
                geom.buckets, geom.per_bucket(lo), geom.per_bucket(hi))])
            shapes = bdd_shapes(geom.buckets)
            bounds = {"uniform_forward": launch_bytes(shapes, itemsize, True),
                      "uniform_backward": launch_bytes(shapes, itemsize, False),
                      RUN: run_bytes(shapes, itemsize)}
            print(f"[split] {label} {dt}: buckets {[tuple(s) for s in geom.plan.shapes]}, bounds "
                  + ", ".join(f"{k} {1e3 * v / HBM_BYTES_PER_S:.4f} ms" for k, v in bounds.items())
                  + f" {card}", flush=True)
            for variant, libname, force, kinds in SPLIT_RUNS:
                if kind not in kinds:
                    continue
                _build._LIB = libs[libname]
                plan = variant_plan(geom.plan.shapes, dtype, "cuda", **{"body": "huge", **force})
                if variant == "staged":  # two ring rows of cft beside the plan's block
                    cft_row = -(-geom.plan.shapes[0][0] * itemsize // 16) * 16
                    huge = launch_of(plan, HUGE)
                    huge = dataclasses.replace(huge, smem_forward=huge.smem_forward + 2 * cft_row)
                    plan = dataclasses.replace(plan, sweeps=(huge,), runs=(huge,))
                    if 2 * (huge.smem_forward + layout.BLOCK_SMEM_RESERVED) > layout.SM_SMEM:
                        fail(f"{label} {dt}: a staged block does not leave room for two an SM")
                launches = {
                    "uniform_forward": sk.prepare_fused_launch(
                        "uniform_forward", geom, lo, hi, cft, 0.5, dl, dh, plan),
                    "uniform_backward": sk.prepare_fused_launch(
                        "uniform_backward", geom, ref_f[0], ref_f[1], ref_f[3], 0.5, dl, dh,
                        plan),
                    RUN: sk.prepare_run_launch(geom, lo, hi, plan)}
                if variant == "staged":  # only the forward differs
                    launches = {"uniform_forward": launches["uniform_forward"]}
                row = []
                for kernel, (launch, out) in launches.items():
                    launch()
                    torch.cuda.synchronize()
                    ref = {"uniform_forward": ref_f, "uniform_backward": ref_b}.get(kernel,
                                                                                    [ref_r])
                    compare(out if kernel != RUN else [out], ref, 0.0)
                    warm, cold = cuda_ms(launch, 100), cuda_ms(launch, 10, flush)
                    bound = 1e3 * bounds[kernel] / HBM_BYTES_PER_S
                    row.append(f"{kernel} warm {warm:.4f} ms ({100 * bound / warm:.1f}% of bound), "
                               f"cold {cold:.4f} ms")
                print(f"[split] {label} {dt} {variant} ({plan_text(plan)}): match; "
                      f"{'; '.join(row)} {card}", flush=True)
            del host, geom, st, ref_f, ref_b, ref_r
            torch.cuda.empty_cache()
    _build._LIB = None


def huge_ring() -> None:
    """``--huge-ring``: the shared-memory huge body's ring form alone, on the
    benchmark's gap_d60900 layout: its counting entries (``gap_counted``: bit
    for bit against the uncounted launches, and what they cost), both forms
    and the ring's depths (``gap_forms``); then the kernels line of those
    paths."""
    import torch
    from bdd_tpu_torch import _build

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: --huge-ring needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"[{smi}]"
    _build.build_all()
    _build.load()
    errs = {name + suffix: 0.0 for name in KERNELS + (RUN,) for suffix in BODIES}
    times = {}
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    paths = [gap_counted(card, errs, times)]
    paths += gap_forms(card, errs, times, flush)
    del flush
    finish(paths, errs, times)


def main() -> None:
    # the native C++ baseline's OpenMP pool reads these when first loaded
    for k, v in (("OMP_NUM_THREADS", str(os.cpu_count() or 4)), ("OMP_WAIT_POLICY", "active")):
        os.environ.setdefault(k, v)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"[{smi}]"

    # ------------------------------------------------------ 1. card + build
    from bdd_tpu_torch import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    _build.load()
    print(f"[build] {', '.join(os.path.relpath(p) for p in paths.values())} "
          f"(nvcc and g++ side by side) in {time.perf_counter() - t0:.2f} s {card}", flush=True)
    errs = {name + suffix: 0.0 for name in KERNELS + (RUN,) for suffix in BODIES}
    times = {}
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    from bdd_tpu_torch.native import NativeHost
    from bdd_tpu_torch.solver import layout
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf
    from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver
    from bdd_tpu_torch.utils.problems import grid_mrf

    # --------------------------------------------- 2. kernels vs twins
    t0 = time.perf_counter()
    gm_lp = gm50k_lp()
    nh = NativeHost(gm_lp, "bfs")
    print(f"[gm50k] {nh.nr_bdds()} BDDs, {nh.nr_vars()} variables, {nh.nr_buckets()} raw "
          f"buckets, built in {time.perf_counter() - t0:.2f} s {card}", flush=True)
    gm_f32 = layout.from_native_host(nh, torch.float32, "cuda")
    gm_f64 = layout.from_native_host(nh, torch.float64, "cuda")
    gm_unpacked = layout.from_native_host(nh, torch.float32, "cuda", pack=False)
    kernel_vs_twin("gm50k", gm_f32, nh.objective(), card, errs, times, flush,
                   variants=({"stages": 1}, {"stages": 8}))
    kernel_vs_twin("gm50k", gm_f64, nh.objective(), card, errs, times, flush)
    kernel_vs_twin("gm50k unpacked", gm_unpacked, nh.objective(), card, errs, times, flush)
    grid_nh = NativeHost(grid_mrf(12, 12, 4, seed=0).write_lp(), "bfs")
    kernel_vs_twin("grid12", layout.from_native_host(grid_nh, torch.float32, "cuda"),
                   grid_nh.objective(), card, errs, times, flush)
    print(f"[kernel] all narrow buckets and all fused launches match, max |diff| {errs}",
          flush=True)

    # ------------------------------------------------ 3. main path at size
    sk.reset_launch_counts()
    f32a = solve_dual(gm_lp, "float")
    launches = dict(sk.LAUNCHES)
    print(f"[main] launches in the float32 gm50k solve: {launches}", flush=True)
    if min(launches[k] for k in KERNELS) == 0:
        fail(f"a kernel of the main path was never launched: {launches}")
    f32b = solve_dual(gm_lp, "float")
    sk.reset_launch_counts()
    f64 = solve_dual(gm_lp, "double")
    launches64 = dict(sk.LAUNCHES)
    print(f"[main] launches in the float64 gm50k solve: {launches64}", flush=True)
    for res, counted in ((f32a, launches), (f64, launches64)):
        if sweeps_of(counted) != launch_counts(narrow=res["iterations"]):
            fail(f"gm50k: launches {counted} in {res['iterations']} iterations; expected one "
                 f"narrow launch per kernel and iteration")
    paths = [{"at": "gm50k", "dt": "float32", "suffix": "", "launches": launches,
              "iterations": f32a["iterations"]}]
    cs = nh.cpu_solver()
    t0 = time.perf_counter()
    cs.iterations(GM_ITERS, 0.5)
    native_s = time.perf_counter() - t0
    lb_native = cs.lower_bound_with_deferred()
    threads = cs.nr_threads()
    for name, res, prec in (("float32", f32a, "float"), ("float64", f64, "double")):
        rel = abs(res["lower_bound"] - lb_native) / abs(lb_native)
        print(f"[main] gm50k {name}: lb {res['lower_bound']!r} after {res['iterations']} "
              f"iterations vs the port's native C++ solver {lb_native!r}: rel diff {rel:.3e} "
              f"(limit {LB_REL[prec]}), solve {res['solve_time']} s {card}", flush=True)
        if res["iterations"] != GM_ITERS or not rel <= LB_REL[prec]:
            fail(f"gm50k {name} bound off the native solver")
    if f32a["lower_bound"] != f32b["lower_bound"]:
        fail(f"float32 bound not deterministic: {f32a['lower_bound']!r} vs {f32b['lower_bound']!r}")
    print(f"[main] float32 rerun bit-identical: {f32b['lower_bound']!r}", flush=True)

    # ---------------------------------------- 4. main path with rounding
    ilp = grid_mrf(12, 12, 4, seed=0)
    from bdd_tpu_torch.api import BddSolver

    s = BddSolver(device="cuda").read_ilp(ilp=ilp)
    t0 = time.perf_counter()
    res = s.solve(verbose=False)
    grid_s = time.perf_counter() - t0
    if "solution" not in res:
        fail(f"grid12 rounding found no solution: {res}")
    x = [res["solution"][ilp.get_var_name(i)] for i in range(ilp.nr_variables())]
    if not ilp.feasible(x):
        fail("grid12 rounded solution is infeasible")
    obj = ilp.evaluate(x)
    lb = res["lower_bound"]
    if abs(obj - res["objective"]) > 1e-6 * max(1.0, abs(obj)) or obj < lb - 1e-5 * abs(lb):
        fail(f"grid12 objective {obj} vs reported {res['objective']}, lb {lb}")
    print(f"[round] grid12 default config: lb {lb!r}, objective {obj!r}, gap "
          f"{(obj - lb) / abs(obj):.4%}, {res['iterations']} dual iterations, "
          f"{grid_s:.2f} s wall {card}", flush=True)

    # ------------------------------------------------------- 5. times
    def its_per_s(sweeps, n):
        sol = UniformSolver(gm_f32, nh.objective())
        sol.state = uf.iterations(sol.geom, sol.state, 2, sweeps=sweeps)  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        sol.state = uf.iterations(sol.geom, sol.state, n, sweeps=sweeps)
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t)

    kern = its_per_s(None, 200)
    twin = its_per_s(uf.TWIN_SWEEPS, 10)
    print(f"[time] gm50k float32 iterations/s: kernels {kern:.1f}, twins on the card "
          f"{twin:.2f}, native C++ ({threads} threads) {GM_ITERS / native_s:.1f} {card}",
          flush=True)
    for (label, dt), d in sorted(times.items()):
        for name, e in d.items():
            if name == RUN:  # its own [run] line has it
                continue
            print(f"[time] {label} {dt} {name}: fused launch warm {e['ms']:.4f} ms, cold "
                  f"{e['cold_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms ({e['bytes']} B), "
                  f"per-bucket launches summed {e['bucket_ms']:.4f} ms, twins "
                  f"{e['plain_ms']:.4f} ms {card}", flush=True)
    syncs = profile_block("gm50k float32", gm_f32, nh.objective(), card)
    syncs += profile_block("gm50k float64", gm_f64, nh.objective(), card)
    if syncs:
        fail(f"{syncs} host syncs inside an iteration block; expected 0")

    # ------------------------------------------------ 6-13. the later slices
    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s {card}", flush=True)
        return out

    paths.append(timed("wide", phase_wide, card, errs, times, flush))
    paths += timed("huge", phase_huge, card, errs, times, flush)
    paths.append(timed("python", phase_python_pipeline, card, errs, times, flush))
    paths += timed("batch", phase_batch, card, errs, times, flush)
    paths.append(timed("serve", phase_serve, card, gm_lp, f32a["lower_bound"], errs, times,
                       flush))
    outer, gm_python = timed("outer", phase_outer, card, gm_lp, gm_f32, nh.objective(), errs,
                             times, flush)
    paths += outer
    paths.append(timed("tighten", phase_tighten, card, errs, times, flush))
    timed("smooth", phase_smooth, card, gm_python)
    paths += timed("hybrid", phase_hybrid, card, errs, times, flush, gm_python, nh, gm_f32,
                   f32a["lower_bound"])
    paths += timed("learned", phase_learned, card, errs, times, flush, gm_python)
    paths += timed("sharded", phase_sharded, card, errs, times, gm_lp, {
        "float32": f32a["lower_bound"], "float64": f64["lower_bound"], "native": lb_native})
    timed("dense", phase_dense, card, gm_python, {"float32": gm_unpacked, "float64": gm_f64},
          nh.objective())
    del flush
    finish(paths, errs, times)


def finish(paths, errs, times) -> None:
    """The checks and lines that end a run: no JAX imported, the kernels line
    (a row per kernel, body and path), the result line."""
    import torch

    print(f"[kernel] every bucket and fused launch of the phases matches its plain "
          f"version, max |diff| {errs}", flush=True)
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "bdd_tpu", "flax", "optax", "msgpack"))
    if foreign:
        fail(f"the port's main path imported JAX or the JAX package: {foreign[:5]}")

    src = "bdd_tpu_torch/csrc/uniform_sweep.cu"
    replaces = {"uniform_forward": "bdd_tpu/solver/pallas_uniform.py:112",
                "uniform_backward": "bdd_tpu/solver/pallas_uniform.py:183",
                # an entry of the backward kernel's bodies: the function is the
                # scan of bdd_tpu/solver/uniform.py:1208
                RUN: "bdd_tpu/solver/pallas_uniform.py:183"}
    # one row per kernel, body and path: the launches are those of the path's
    # own run, the times and bytes those of its layout, max_abs_err the
    # largest over every comparison of that body
    rows = []
    for path in paths:
        for name in path.get("entries", KERNELS + (RUN,)):
            e = times[(path["at"], path["dt"])][name]
            # the run-only entry takes its own route (the cluster body's buckets on the L2 body)
            suffix = path.get("run_suffix", path["suffix"]) if name == RUN else path["suffix"]
            key = name + suffix
            count = path["launches"][key]
            if count == 0:
                fail(f"{key} was never launched on the path {path['at']}")
            rows.append({
                "name": key, "at": f"{path['at']} {path['dt']}",
                "route": "cuda", "source": src, "replaces": replaces[name], "launches": count,
                "launches_per_iteration": path["iterations"] and count / path["iterations"],
                "max_abs_err": errs[key], "ms": e["ms"],
                "cold_ms": e["cold_ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                "bound_by": "bytes", "bytes": e["bytes"], "library_ms": None,
                # the counting entries' rows: the uncounted launch's time, the wait share
                **{k: e[k] for k in ("uncounted_ms", "wait_pct") if k in e}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sharded_rank(sys.argv[2:])
    elif sys.argv[1:2] == ["--huge-split"]:
        huge_split(sys.argv[2:])
    elif sys.argv[1:2] == ["--huge-ring"]:
        huge_ring()
    else:
        main()
