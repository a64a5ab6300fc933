"""One run of one cell: set-up, the timed window, the check, the result line.

The window runs back-to-back dual solves of one instance: each starts from the
instance's initial dual state (``uniform.init_uniform_state``) and runs the
cell's fixed iteration count through ``BddSolver.solve_dual`` on the
``UniformSolver`` (its block size and bound checks, no stopping rule), as a
user who submits the instance again would. After the window the last solve's
lower bound and dual state are compared with the plain reference
(:mod:`portbench.reference`), run from the same model in float64.
"""
from __future__ import annotations

import math
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from portbench import reference, spec, work
from portbench.devtrace import Trace, breakdown

FORBIDDEN = ("jax", "jaxlib", "flax", "bdd_tpu")
CHECKS = ("bound_gap", "bdd_bound_gap", "state_gap")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``bdd_tpu_torch`` is not ``bdd_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """A cell's files, its instance for a seed, and the program set up on it."""

    def __init__(self, name: str, seed: int, device: str = "cuda",
                 instance: Optional[dict] = None) -> None:
        self.name = name
        self.bench = spec.benchmark()
        self.workload = spec.workload(name)
        self.config = spec.config(self.workload["config"])
        params = {**self.config["instance"], **self.workload.get("instance", {}),
                  **(instance or {})}
        self.model = spec.generator(self.config["generator"]).make(params, seed)
        self.iterations = int(self.workload["iterations_per_solve"])
        self.device = device

    def solver_config(self) -> dict:
        return {**self.config["solver"], "termination criteria": {
            "maximum iterations": self.iterations, "minimum improvement": 0.0,
            "improvement slope": 0.0, "time limit": 1e9}}

    def set_up(self) -> None:
        """The program on the instance: its native host build, the layout on
        the device, the solver object."""
        from bdd_tpu_torch.api import BddSolver
        from bdd_tpu_torch.native import NativeHost
        from bdd_tpu_torch.solver.layout import from_native_host
        from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver

        lp = self.model.lp_text()
        self.api = BddSolver(self.solver_config(), device=self.device).read_ilp(lp_string=lp)
        self.native = NativeHost(lp, self.api.config["variable order"])
        self.host = from_native_host(self.native, dtype=self.api.dtype, device=self.api.device)
        self.objective = self.native.objective()
        self.itemsize = torch.finfo(self.api.dtype).bits // 8
        self.api.solver = UniformSolver(self.host, self.objective)

    def solve(self):
        """One solve from the initial dual state: (lower bound, iterations)."""
        from bdd_tpu_torch.solver import uniform as uf

        s = self.api.solver
        s.state = uf.init_uniform_state(self.host, self.objective)
        lb = self.api.solve_dual(verbose=False)
        return lb, self.api.dual_stats["iterations"]

    def outputs(self, lb: float) -> dict:
        """The last solve's answer on the host, keyed as the reference keys it:
        slots by (BDD, model variable)."""
        s = self.api.solver
        lo, hi, mm, _ = s.state.flat
        valid = self.host.geom.exchange.valid.cpu().numpy()
        bdd = np.concatenate([np.asarray(b).ravel() for b in self.host.layer_bdd])[valid]
        var = np.concatenate([g.layer_var.cpu().numpy().ravel()
                              for g in self.host.geom.buckets])[valid]
        index = {n: i for i, n in enumerate(self.model.var_names)}
        names = self.native.var_names()
        model_var = np.array([index[names[v]] for v in range(len(names))], dtype=np.int64)
        return {"lower_bound": float(lb), "bdd_bounds": s.lower_bound_per_bdd(),
                "bdd": bdd.astype(np.int64), "var": model_var[var],
                "lo": lo.double().cpu().numpy()[valid], "hi": hi.double().cpu().numpy()[valid],
                "mm": mm.double().cpu().numpy()[valid]}

    def release(self) -> None:
        for k in ("api", "native", "host", "objective"):
            self.__dict__.pop(k, None)
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float64) -> reference.Result:
        layout = self.layout()
        return reference.solve(layout, self.iterations, dtype=dtype, device=self.device)

    def layout(self) -> reference.Layout:
        if not hasattr(self, "_layout"):
            self._layout = reference.build_layout(
                self.model, self.config["solver"].get("variable order", "input"))
        return self._layout


def reference_outputs(res: reference.Result, layout: reference.Layout) -> dict:
    """A reference solve's answer in the form of :meth:`Cell.outputs`."""
    return {"lower_bound": res.lower_bound, "bdd_bounds": res.bdd_bounds,
            "bdd": layout.slot_bdd, "var": layout.slot_var,
            "lo": res.lo, "hi": res.hi, "mm": res.mm}


def _finite_max(x: np.ndarray) -> float:
    f = np.abs(x[np.isfinite(x)])
    return float(f.max()) if f.size else 0.0


def compare(out: dict, ref: reference.Result, layout: reference.Layout) -> Dict[str, float]:
    """The numbers the check holds to its limits:

    - ``bound_gap``: |lower bound - the reference's| over max(1, |the reference's|);
    - ``bdd_bound_gap``: the widest gap of a BDD's root cost to the terminal,
      over the reference's largest;
    - ``state_gap``: the widest gap of a slot's lo, hi or deferred marginal
      over the reference's largest finite one; infinite where the infinite
      entries of the two differ, or where the slots are not the same.
    """
    gaps = {"bound_gap": abs(out["lower_bound"] - ref.lower_bound)
            / max(1.0, abs(ref.lower_bound))}
    if out["bdd_bounds"].shape != ref.bdd_bounds.shape:
        return {**gaps, "bdd_bound_gap": math.inf, "state_gap": math.inf}
    gaps["bdd_bound_gap"] = float(np.abs(out["bdd_bounds"] - ref.bdd_bounds).max()
                                  / max(_finite_max(ref.bdd_bounds), 1e-300))
    key_p = out["bdd"] * layout.nr_vars + out["var"]
    key_r = layout.slot_bdd * layout.nr_vars + layout.slot_var
    ip, ir = np.argsort(key_p), np.argsort(key_r)
    if not np.array_equal(key_p[ip], key_r[ir]):
        return {**gaps, "state_gap": math.inf}
    scale = max(_finite_max(getattr(ref, k)) for k in ("lo", "hi", "mm"))
    gap = 0.0
    for k in ("lo", "hi", "mm"):
        p, r = out[k][ip], getattr(ref, k)[ir]
        fin = np.isfinite(r)
        if not np.array_equal(np.isfinite(p), fin) or not np.array_equal(p[~fin], r[~fin]):
            return {**gaps, "state_gap": math.inf}
        if fin.any():
            gap = max(gap, float(np.abs(p[fin] - r[fin]).max()))
    gaps["state_gap"] = gap / max(scale, 1e-300)
    return gaps


def _power_limit() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run(name: str, seed: int, seconds: float, trace: bool, started: float,
        device: str = "cuda", instance: Optional[dict] = None,
        fault: Optional[Callable[["Cell"], None]] = None, log=sys.stderr) -> dict:
    """One run of a cell; the result line's fields. ``started``: the process's
    start on ``time.monotonic``. ``instance`` overrides instance parameters and
    ``fault`` breaks the program after set-up (both for the tests)."""
    from bdd_tpu_torch.solver import sweep_kernels as sk
    from bdd_tpu_torch.utils.logging import set_console

    set_console(log)
    os.environ.pop("BDD_TPU_TRACE", None)
    cell = Cell(name, seed, device, instance)
    cell.set_up()
    if fault is not None:
        fault(cell)
    cell.solve()  # warm: every shape the window uses
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
    trace_from, trace_solves = 1, int(cell.workload["trace_solves"])
    iterations = solves = failed = 0
    solve_s = []
    summary = None
    t0 = time.monotonic()
    setup_s = t0 - started
    while True:
        if trace and solves == trace_from:
            launched = dict(sk.LAUNCHES)
            tracer = Trace().__enter__()
            traced_from = iterations
        t_solve = time.monotonic()
        lb, n = cell.solve()
        solve_s.append(time.monotonic() - t_solve)
        iterations += n
        solves += 1
        failed += not math.isfinite(lb)
        if trace and solves == trace_from + trace_solves:
            tracer.__exit__(None, None, None)
            summary = tracer.summary()
            summary["iterations"] = iterations - traced_from
            summary["solves"] = trace_solves
            bodies = {k: v - launched[k] for k, v in sk.LAUNCHES.items() if v != launched[k]}
        if time.monotonic() - t0 >= seconds and (not trace or summary is not None):
            break
    if on_card:
        torch.cuda.synchronize()
    window_s = time.monotonic() - t0
    q = np.quantile(solve_s, [0, 0.25, 0.5, 0.75, 1])
    print(f"window: {solves} solves in {window_s:.3f} s; seconds a solve, min quartiles max: "
          + " ".join(f"{x:.5f}" for x in q), file=log)
    ends = np.cumsum(solve_s)
    edges = np.searchsorted(ends, np.arange(1, int(window_s) + 1))
    print("window: solves completed in each second: "
          + " ".join(str(int(x)) for x in np.diff(np.concatenate([[0], edges]))), file=log)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    out = cell.outputs(lb)
    cell.release()
    ref = cell.reference()
    gaps = compare(out, ref, cell.layout())
    limits = cell.workload["check"]
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in CHECKS}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    if trace:
        layout = cell.layout()
        summary["sweep_bytes"] = (
            summary["iterations"] * 2 * work.half_sweep_bytes(layout, cell.itemsize)
            + summary["solves"] * work.run_bytes(layout, cell.itemsize))
        kind = torch.cuda.get_device_name(0) if on_card else "cpu"
        summary["peak_bytes_per_s"] = work.peaks(kind).get("hbm_bytes_per_s")
        kinds = "per_layer"
    else:
        summary = {"iterations": iterations, "window_s": window_s, "setup_s": setup_s}
        kinds = "end_to_end"
    metrics = {}
    for m in spec.metrics_of(cell.bench, name, kinds):
        value = spec.metric_reader(m["name"])(summary)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": solves, "failed": failed, "metrics": metrics}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    if on_card:
        dev["device_count"] = torch.cuda.device_count()
        dev["power_limit_w"] = _power_limit()
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = breakdown(summary)
        result["sweep_launches"] = bodies  # sweep_kernels.LAUNCHES over the traced slice
    result["device"] = dev
    result["checks"] = checks
    return result
