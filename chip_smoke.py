#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (bdd_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

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
     must move over the card's memory rate; gm50k float32 also at forced
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
     between the block's first and last launch, which must be 0.

Imports nothing of JAX and nothing of bdd_tpu (checked at the end): the port
carries its own host library, ILP model, frontends and generators.
Prints the card line, one JSON line of per-kernel results, and as the last
line {"ok": true, "device": {...}}.
"""
import json
import math
import os
import subprocess
import sys
import time

GM_ITERS = 500
TOL = {"float32": 0.0, "float64": 0.0}  # bit-equal: -fmad=false, same op order
LB_REL = {"float": 1e-3, "double": 1e-7}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
L2_FLUSH_BYTES = 256 << 20  # several times the 50 MB L2
KERNELS = ("uniform_forward", "uniform_backward")
SYNC_EVENTS = ("aten::_local_scalar_dense", "aten::item", "cudaStreamSynchronize",
               "cudaDeviceSynchronize", "cudaEventSynchronize")


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def gm50k_lp() -> str:
    from bdd_tpu_torch.frontends.graph_matching import construct_graph_matching_ilp
    from bdd_tpu_torch.utils.problems import graph_matching

    inst = graph_matching(120, 120, seed=0, candidates=6, nr_quadratic=2000)
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


def launch_bytes(shapes, itemsize: int, forward: bool) -> int:
    """Bytes one launch must move: every input read once, every output
    written once. Per (hop, column): the geometry record, lo hi din_lo
    din_hi alpha and P frontier values in, 3 + P values out. The forward
    kernel never reads cft of hop 0."""
    from bdd_tpu_torch.solver.layout import record_bytes

    total = 0
    for P, H, B in shapes:
        frontier_rows = H - 1 if forward else H
        total += H * B * (record_bytes(P) + 5 * itemsize + (3 + P) * itemsize)
        total += frontier_rows * P * B * itemsize
    return total


def share(bound_ms: float, ms: float) -> str:
    if ms < bound_ms:
        return "under the device-memory bound: L2 served it"
    return f"{100 * bound_ms / ms:.1f}% of bound"


def kernel_vs_twin(label, host, objective, card, errs, times, flush, depths=()):
    """Phase 2 for one host: every bucket alone, then all buckets fused;
    ``depths``: prefetch depths to time the fused launches at as well."""
    import torch
    from bdd_tpu_torch.solver import layout
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.solver import uniform as uf

    geom = host.geom
    dt = str(geom.dtype).replace("torch.", "")
    itemsize = torch.empty((), dtype=geom.dtype).element_size()
    st = uf.init_uniform_state(host, objective)
    st = uf.iterations(geom, st, 5)
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
        errs["uniform_forward"] = max(errs["uniform_forward"], compare(out, ref, TOL[dt]))
        bargs = (g, ref[0], ref[1], ref[3], 0.5, dl[k], dh[k])
        out_b = sk.bucket_backward_iteration_cuda(*bargs)
        ref_b = uf.bucket_backward_iteration(*bargs)
        torch.cuda.synchronize()
        errs["uniform_backward"] = max(errs["uniform_backward"], compare(out_b, ref_b, TOL[dt]))
        refs_f.append(ref)
        refs_b.append(ref_b)
        # device time of the kernel alone (pre-validated launches) vs the twin
        launch_f, _ = sk.prepare_launch("uniform_forward", *args)
        launch_b, _ = sk.prepare_launch("uniform_backward", *bargs)
        shape = [(g.P, g.H, g.B)]
        t = {
            "uniform_forward": (cuda_ms(launch_f, 100),
                                cuda_ms(lambda: uf.bucket_forward_iteration(*args), 2),
                                launch_bytes(shape, itemsize, True)),
            "uniform_backward": (cuda_ms(launch_b, 100),
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
            f"launches fwd {sk.LAUNCHES['uniform_forward'] - before['uniform_forward']} "
            f"bwd {sk.LAUNCHES['uniform_backward'] - before['uniform_backward']} {card}",
            flush=True,
        )
    # ---- one fused launch over all buckets against the twins bucket by bucket
    cat = lambda outs: tuple(torch.cat([x.reshape(-1) for x in xs]) for xs in zip(*outs))
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
        errs[name] = max(errs[name], compare(out, ref, TOL[dt]))
        rose = {k: sk.LAUNCHES[k] - before[k] for k in KERNELS}
        if rose != {k: int(k == name) for k in KERNELS}:
            fail(f"{label} {dt}: one fused {name} call counted launches {rose}")
    # the timing loops launch directly: checked once, no allocation, no count
    launch_f, _ = sk.prepare_fused_launch("uniform_forward", *args_f)
    launch_b, _ = sk.prepare_fused_launch("uniform_backward", *args_b)
    wrapper_ms = cuda_ms(
        lambda: sk.forward_iteration_cuda(geom, lo, hi, cft, 0.5, dl_flat, dh_flat), 50)
    plan = geom.plan
    for name, launch, fwd in (("uniform_forward", launch_f, True),
                              ("uniform_backward", launch_b, False)):
        nbytes = launch_bytes(plan.shapes, itemsize, fwd)
        e = entry[name]
        e.update(ms=cuda_ms(launch, 200), cold_ms=cuda_ms(launch, 20, flush), bytes=nbytes,
                 bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)
        print(
            f"[fused] {label} {dt} {name}: one launch over {plan.nr_buckets} bucket(s), "
            f"{plan.nr_blocks} blocks of {plan.tile}, stages "
            f"{[int(s) for s in plan.table[:, 7].tolist()]}, {plan.smem_bytes} B shared: match; "
            f"warm {e['ms']:.4f} ms ({share(e['bound_ms'], e['ms'])}), "
            f"cold {e['cold_ms']:.4f} ms ({share(e['bound_ms'], e['cold_ms'])}), "
            f"bound {e['bound_ms']:.4f} ms = {nbytes} B at 3.35 TB/s; per-bucket launches "
            f"summed {e['bucket_ms']:.4f} ms; twins summed {e['plain_ms']:.4f} ms {card}",
            flush=True,
        )
    print(f"[fused] {label} {dt} forward wrapper call (checks, 4 allocations, 1 launch): "
          f"{wrapper_ms:.4f} ms per call {card}", flush=True)
    for stages in depths:
        deep = layout.launch_plan(plan.shapes, geom.dtype, geom.device, stages=stages)
        row = []
        for name, args, fwd in (("uniform_forward", args_f, True),
                                ("uniform_backward", args_b, False)):
            launch, out = sk.prepare_fused_launch(name, *args, plan=deep)
            launch()
            torch.cuda.synchronize()
            compare(out, ref_f if fwd else ref_b, TOL[dt])
            row.append(f"{name} warm {cuda_ms(launch, 200):.4f} ms, cold "
                       f"{cuda_ms(launch, 20, flush):.4f} ms")
        print(f"[depth] {label} {dt} stages {[int(s) for s in deep.table[:, 7].tolist()]}, "
              f"{deep.smem_bytes} B shared: match; {'; '.join(row)} {card}", flush=True)


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
    errs = {name: 0.0 for name in KERNELS}
    times = {}
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gm_f32 = layout.from_native_host(nh, torch.float32, "cuda")
    gm_f64 = layout.from_native_host(nh, torch.float64, "cuda")
    kernel_vs_twin("gm50k", gm_f32, nh.objective(), card, errs, times, flush, depths=(1, 8))
    kernel_vs_twin("gm50k", gm_f64, nh.objective(), card, errs, times, flush)
    kernel_vs_twin("gm50k unpacked", layout.from_native_host(nh, torch.float32, "cuda", pack=False),
                   nh.objective(), card, errs, times, flush)
    grid_nh = NativeHost(grid_mrf(12, 12, 4, seed=0).write_lp(), "bfs")
    kernel_vs_twin("grid12", layout.from_native_host(grid_nh, torch.float32, "cuda"),
                   grid_nh.objective(), card, errs, times, flush)
    del flush
    print(f"[kernel] all buckets and all fused launches match, max |diff| {errs}", flush=True)

    # ------------------------------------------------ 3. main path at size
    sk.reset_launch_counts()
    f32a = solve_dual(gm_lp, "float")
    launches = dict(sk.LAUNCHES)
    print(f"[main] launches in the float32 gm50k solve: {launches}", flush=True)
    if min(launches.values()) == 0:
        fail(f"a kernel of the main path was never launched: {launches}")
    f32b = solve_dual(gm_lp, "float")
    sk.reset_launch_counts()
    f64 = solve_dual(gm_lp, "double")
    launches64 = dict(sk.LAUNCHES)
    print(f"[main] launches in the float64 gm50k solve: {launches64}", flush=True)
    per_iteration = {}
    for name in KERNELS:
        a, b = launches[name] / f32a["iterations"], launches64[name] / f64["iterations"]
        if a != 1 or b != 1:
            fail(f"{name}: {a} launches per iteration in float32, {b} in float64; expected 1")
        per_iteration[name] = 1
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
            print(f"[time] {label} {dt} {name}: fused launch warm {e['ms']:.4f} ms, cold "
                  f"{e['cold_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms ({e['bytes']} B), "
                  f"per-bucket launches summed {e['bucket_ms']:.4f} ms, twins "
                  f"{e['plain_ms']:.4f} ms {card}", flush=True)
    syncs = profile_block("gm50k float32", gm_f32, nh.objective(), card)
    syncs += profile_block("gm50k float64", gm_f64, nh.objective(), card)
    if syncs:
        fail(f"{syncs} host syncs inside an iteration block; expected 0")

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "bdd_tpu"))
    if foreign:
        fail(f"the port's main path imported JAX or the JAX package: {foreign[:5]}")

    src = "bdd_tpu_torch/csrc/uniform_sweep.cu"
    replaces = {"uniform_forward": "bdd_tpu/solver/pallas_uniform.py:112",
                "uniform_backward": "bdd_tpu/solver/pallas_uniform.py:183"}
    main_shape = times[("gm50k", "float32")]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces[name],
         "launches": launches[name], "launches_per_iteration": per_iteration[name],
         "max_abs_err": errs[name], "ms": main_shape[name]["ms"],
         "cold_ms": main_shape[name]["cold_ms"], "plain_ms": main_shape[name]["plain_ms"],
         "bound_ms": main_shape[name]["bound_ms"], "bound_by": "bytes",
         "bytes": main_shape[name]["bytes"], "library_ms": None}
        for name in KERNELS
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
