"""Top-level solver pipeline + CLI (counterpart of bdd_tpu/api.py).

JSON-config compatible with the reference schema:

    read ILP -> variable reorder -> normalize -> ILP->BDD -> dual solver ->
    perturbation rounding.

Two preprocessing pipelines lead to the same bucketed layout on the device:

    native: LP text -> C++ host library (parse, order, BDDs, buckets)
    python: ILP object -> BddPreprocessor -> BddCollection -> flatten_uniform

The native one is the fast way and is taken whenever the config and the input
allow it; ``_try_native`` logs which pipeline ran and why. That is a choice
of preprocessing only: either way the uniform solver lives on ``device``
(default ``"cuda"``) and sweeps through the CUDA kernels there.

Relaxation solver names:
    "uniform mma" / "cuda parallel mma" / "jax mma" / "mma" -> bucketed
        uniform backend on the device
    "lbfgs parallel mma" / "lbfgs cuda parallel mma" / "lbfgs jax mma" ->
        L-BFGS outer loop over the uniform backend (config block "lbfgs")
    "subgradient" -> adaptive subgradient ascent over the uniform backend
    "smooth mma" / "mma smooth" / "parallel mma smooth" -> smoothed dual
        ascent with temperature annealing (keys "smoothing", "smoothing decay
        factor", "min smoothing"; a bare "smoothing" key selects it)
    "sequential mma", "parallel mma" / "ref mma" -> numpy backends on the host
    "sharded mma" / "lbfgs sharded mma" / "subgradient sharded mma" -> the
        BDDs partitioned over the ranks of a torch.distributed process group,
        one shard a rank (key "partition": "auto", "block" or "mincut"); one
        shard on the device without a group
    "dense mma" -> the dense hop-scan backend (``solver/dense.py``) on the
        device, built from the Python pipeline's flat BDD arrays
The key ``"tighten"`` (true, or {"cliques", "odd cycles", "eps", "node
limit"}) adds the cut-tightening phase after the dual solve.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor, InfeasibleError
from bdd_tpu_torch.ilp.lp_parser import parse_lp_string
from bdd_tpu_torch.native import NativeHost, NativeUnsupported
from bdd_tpu_torch.solver.flatten import flatten_collection
from bdd_tpu_torch.solver.layout import from_native_host, resolve_device
from bdd_tpu_torch.solver.rounding import incremental_mm_rounding
from bdd_tpu_torch.solver.rounding_device import Draws, incremental_mm_rounding_device
from bdd_tpu_torch.solver.run import run_solver
from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver
from bdd_tpu_torch.utils.logging import bdd_log

# api.py:31-59 of the JAX package
DEFAULT_CONFIG = {
    "variable order": "input",  # input|bfs|minimum degree|cuthill
    "use native preprocessing": True,  # C++ host pipeline when applicable
    "normalize constraints": True,
    "precision": "float",  # float|double
    "relaxation solver": "uniform mma",
    "split chunk size": None,  # cap BDD depth; int or "auto"
    "split implication": False,  # redundant cross-chunk implication BDD
    "termination criteria": {
        "maximum iterations": 1000,
        "improvement slope": 1e-9,
        "minimum improvement": 1e-6,
        "time limit": 3600,
    },
    "perturbation rounding": {
        "initial perturbation": math.inf,
        "perturbation growth rate": 1.1,
        "inner iterations": 100,
        "outer iterations": 500,
    },
}

UNIFORM_SOLVERS = ("uniform mma", "cuda parallel mma", "jax mma", "mma")
LBFGS_SOLVERS = ("lbfgs parallel mma", "lbfgs cuda parallel mma", "lbfgs jax mma")
OUTER_SOLVERS = LBFGS_SOLVERS + ("subgradient",)  # outer loops over the uniform backend
SMOOTH_SOLVERS = ("smooth mma", "mma smooth", "parallel mma smooth")
HOST_SOLVERS = ("sequential mma", "parallel mma", "ref mma")
# deep BDDs on the native solver's worker thread, the rest on the card
HYBRID_SOLVERS = ("hybrid mma", "multi parallel mma", "hybrid parallel mma")
# the BDDs partitioned over the ranks of a process group (bdd_tpu/api.py:318-347)
SHARDED_SOLVERS = ("sharded mma", "lbfgs sharded mma", "subgradient sharded mma")
DENSE_SOLVERS = ("dense mma",)
_ORDERS = ("input", "bfs", "cuthill", "minimum degree", "mindegree")
_EXPORT_KEYS = ("export lp", "export bdd lp", "export bdd graph", "print statistics",
                "export difficult core")

def _merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            out[k] = _merge(base[k], v)
        else:
            out[k] = v
    return out


def _lbfgs_kwargs(config: dict) -> dict:
    """Accept the reference's spaced JSON keys of the "lbfgs" block."""
    rename = {
        "history size": "history_size",
        "initial step size": "init_step_size",
        "required relative lb increase": "required_relative_lb_increase",
        "step size decrease factor": "step_size_decrease_factor",
        "step size increase factor": "step_size_increase_factor",
    }
    return {rename.get(k, k): v for k, v in config.get("lbfgs", {}).items()}


def _write_ilp(ilp, path: str, what: str) -> None:
    if path.endswith(".opb"):
        text = ilp.write_opb()
    elif path.endswith(".mps"):
        text = ilp.write_mps()
    elif path.endswith(".lp"):
        text = ilp.write_lp()
    else:
        raise ValueError(
            f"Cannot recognize file extension of {path!r} for {what} (.lp/.opb/.mps)")
    with open(path, "w") as fh:
        fh.write(text)


class BddSolver:
    """The orchestration class of ``bdd_tpu.api.BddSolver`` on one device."""

    def __init__(self, config: Optional[dict] = None, device="cuda", **kwargs) -> None:
        config = _merge(DEFAULT_CONFIG, config or {})
        config = _merge(config, kwargs)
        # Reference-spelled BDD-splitting block:
        #   "split bdds": {"split length": N, "implication bdd": true}
        # maps onto the "split chunk size"/"split implication" keys; without
        # a length it means an automatic length.
        sb = config.get("split bdds")
        if sb is not None and sb is not False:
            sb = sb if isinstance(sb, dict) else {}
            if not config.get("split chunk size"):
                config["split chunk size"] = sb.get("split length", "auto")
            if "implication bdd" in sb or "implication" in sb:
                config["split implication"] = bool(
                    sb.get("implication bdd", sb.get("implication"))
                )
        if config.get("smoothing") and "smooth" not in str(config.get("relaxation solver", "")):
            # a "smoothing" key with a non-smooth solver selects the smoothed
            # dual ascent (api.py:104-113 of the JAX package)
            bdd_log("[bdd solver] smoothing requested: switching relaxation "
                    "solver to 'smooth mma'")
            config["relaxation solver"] = "smooth mma"
        self.config = config
        self.device = resolve_device(device)
        self._ilp = None
        self._lp_text: Optional[str] = None
        self._native: Optional[NativeHost] = None
        self.solver = None
        self.infeasible = False
        self.var_perm = None  # old index per new position (None = identity)
        self.dual_stats: dict = {}
        self.tighten_stats: dict = {}  # what the tightening phase did and its wall times
        self._check_config()

    def _check_config(self) -> None:
        cfg = self.config
        name = cfg["relaxation solver"]
        if name not in (UNIFORM_SOLVERS + OUTER_SOLVERS + SMOOTH_SOLVERS + HOST_SOLVERS
                        + HYBRID_SOLVERS + SHARDED_SOLVERS + DENSE_SOLVERS):
            raise ValueError(f"unknown relaxation solver {name!r}")
        if name in SHARDED_SOLVERS:
            from bdd_tpu_torch.solver.uniform_sharded import PARTITIONS

            if cfg.get("partition", "auto") not in PARTITIONS:
                raise ValueError(f"unknown partition {cfg['partition']!r}: one of {PARTITIONS}")
        if cfg["variable order"] not in _ORDERS:
            raise ValueError(f"unknown variable order {cfg['variable order']!r}")
        if cfg["precision"] not in ("float", "double"):
            raise ValueError(f"unknown precision {cfg['precision']!r}")

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.config["precision"] == "double" else torch.float32

    @property
    def ilp(self):
        if self._ilp is None and self._lp_text is not None:
            self._ilp = parse_lp_string(self._lp_text)
        return self._ilp

    @ilp.setter
    def ilp(self, value):
        self._ilp = value

    # ------------------------------------------------------------------ input
    def read_ilp(self, ilp=None, path: Optional[str] = None, lp_string: Optional[str] = None):
        if ilp is not None:
            self._ilp = ilp
        elif lp_string is not None:
            self._lp_text = lp_string  # python parse deferred (native path)
        elif path is not None:
            # Specialized problem frontends: the "input type" config key or
            # the file extension selects the frontend.
            input_type = str(self.config.get("input type", "")).lower()
            if input_type in ("uai", "mrf", "uai mrf") or (
                not input_type and path.endswith(".uai")
            ):
                from bdd_tpu_torch.frontends.mrf_uai import parse_uai_file

                self._ilp = parse_uai_file(path).convert_to_ilp()
            elif input_type in ("graph matching", "gm") or (
                not input_type and path.endswith(".dd")
            ):
                from bdd_tpu_torch.frontends.graph_matching import parse_graph_matching_file

                self._ilp = parse_graph_matching_file(path)
            elif input_type in ("multi graph matching", "mgm") or (
                not input_type and path.endswith(".mgm")
            ):
                from bdd_tpu_torch.frontends.multi_graph_matching import (
                    construct_multi_graph_matching_ilp,
                    parse_mgm_file,
                )

                self._ilp = construct_multi_graph_matching_ilp(parse_mgm_file(path))
            elif path.endswith(".opb"):
                from bdd_tpu_torch.ilp.opb_parser import parse_opb_file

                self._ilp = parse_opb_file(path)
            elif path.endswith(".mps"):
                from bdd_tpu_torch.ilp.mps_parser import parse_mps_file

                self._ilp = parse_mps_file(path)
            else:
                with open(path) as fh:
                    self._lp_text = fh.read()
        else:
            path = self.config.get("input")
            if path is None:
                raise ValueError("no input given")
            return self.read_ilp(path=path)
        return self

    @staticmethod
    def _reorder(ilp, order: str):
        if order == "bfs":
            return ilp.reorder_bfs()
        if order == "cuthill":
            return ilp.reorder_cuthill_mckee()
        if order in ("minimum degree", "mindegree"):
            return ilp.reorder_minimum_degree()
        if order != "input":
            raise ValueError(f"unknown variable order {order!r}")
        return None

    def process_ilp(self):
        perm = self._reorder(self.ilp, self.config["variable order"])
        if perm is not None:
            self.var_perm = perm
        if self.config["normalize constraints"]:
            self.ilp.normalize()
        return self

    def transform_to_bdds(self):
        self.pre = BddPreprocessor(
            self.ilp,
            split_chunk_size=self.config["split chunk size"],
            split_implication_bdd=self.config["split implication"],
        )
        self.flat = flatten_collection(
            self.pre.collection,
            self.pre.total_nr_variables(),
            self.pre.nr_primal_variables,
        )
        bdd_log(
            f"[bdd solver] {self.flat.nr_bdds} BDDs, {self.flat.nr_nodes} nodes, "
            f"{self.flat.nr_layers} layers, {self.flat.nr_hops} hops, "
            f"{self.flat.nr_vars} variables"
        )
        return self

    # ------------------------------------------------------- export phases
    # (export_lp after process_ilp; print_statistics / export_bdd_graph /
    # export_bdd_lp after transform_to_bdds)
    def export_lp_file(self) -> None:
        path = self.config.get("export lp")
        if path:
            _write_ilp(self.ilp, path, "exporting problem file")

    def print_statistics(self) -> None:
        """ILP/BDD size statistics."""
        if not self.config.get("print statistics"):
            return
        ilp = self.ilp
        counts = np.zeros(ilp.nr_variables(), dtype=np.int64)
        for c in ilp.constraints():
            for v in c.variables():
                counts[v] += 1
        bdd_log(f"[print_statistics] #variables = {ilp.nr_variables()}")
        bdd_log(f"[print_statistics] #constraints = {ilp.nr_constraints()}")
        bdd_log(f"[print_statistics] #BDDs = {self.pre.collection.nr_bdds()}")
        if len(counts):
            bdd_log("[print_statistics] minimum num. constraints per var = "
                    f"{int(counts.min())}")
            bdd_log("[print_statistics] maximum num. constraints per var = "
                    f"{int(counts.max())}")
            bdd_log("[print_statistics] mean num. constraints per var = "
                    f"{float(counts.mean())}")

    def export_bdd_graph(self) -> None:
        """One graphviz .dot file per BDD, ``<base>_<nr>.dot``."""
        path = self.config.get("export bdd graph")
        if not path:
            return
        base = path[:-4] if path.endswith(".dot") else path
        col = self.pre.collection
        for bdd_nr in range(col.nr_bdds()):
            with open(f"{base}_{bdd_nr}.dot", "w") as fh:
                fh.write(col.export_graphviz(bdd_nr))

    def export_bdd_lp_file(self) -> None:
        path = self.config.get("export bdd lp")
        if not path:
            return
        with open(path, "w") as fh:
            fh.write(self.pre.collection.write_bdd_lp(self.pre.objective_vector()))

    def construct_solver(self):
        name = self.config["relaxation solver"]
        obj = self.pre.objective_vector()
        np_dtype = np.float64 if self.config["precision"] == "double" else np.float32
        if name == "sequential mma":
            from bdd_tpu_torch.solver.sequential import SequentialSolver

            self.solver = SequentialSolver(self.flat, obj, dtype=np_dtype)
        elif name in ("parallel mma", "ref mma"):
            from bdd_tpu_torch.solver.ref_solver import RefSolver

            self.solver = RefSolver(self.flat, obj, dtype=np_dtype)
        elif name in UNIFORM_SOLVERS + OUTER_SOLVERS:
            base = UniformSolver.from_collection(
                self.pre.collection,
                self.pre.total_nr_variables(),
                obj,
                nr_primal_vars=self.pre.nr_primal_variables,
                dtype=self.dtype,
                device=self.device,
            )
            if name in LBFGS_SOLVERS:
                from bdd_tpu_torch.solver.lbfgs import LbfgsSolver

                base = LbfgsSolver(base, **_lbfgs_kwargs(self.config))
            elif name == "subgradient":
                from bdd_tpu_torch.solver.subgradient import SubgradientSolver

                base = SubgradientSolver(base)
            self.solver = base
        elif name in DENSE_SOLVERS:
            # the dense hop-scan backend over the Python pipeline's flat
            # arrays (bdd_tpu/api.py:379-399; never from the native host)
            from bdd_tpu_torch.solver.dense_wrapper import DenseSolver

            self.solver = DenseSolver(self.flat, obj, dtype=self.dtype, device=self.device)
        elif name in SMOOTH_SOLVERS:
            from bdd_tpu_torch.solver.smooth_mma import SmoothSolver

            smoothing = self.config.get("smoothing")
            self.solver = SmoothSolver.from_collection(
                self.pre.collection,
                self.pre.total_nr_variables(),
                obj,
                nr_primal_vars=self.pre.nr_primal_variables,
                dtype=self.dtype,
                device=self.device,
                smoothing=(float(smoothing) if isinstance(smoothing, (int, float))
                           and not isinstance(smoothing, bool) else 0.1),
                smoothing_decay=float(self.config.get("smoothing decay factor", 0.5)),
                min_smoothing=float(self.config.get("min smoothing", 1e-3)),
            )
        elif name in HYBRID_SOLVERS:
            # the deep BDDs on the native C++ OpenMP solver (a worker
            # thread), the short ones on the card, the delta summed across
            # both every half-sweep (bdd_tpu/api.py:295-317)
            from bdd_tpu_torch.solver.hybrid import HybridSolver

            self.solver = HybridSolver(
                self.pre.collection,
                self.pre.total_nr_variables(),
                obj,
                nr_primal_vars=self.pre.nr_primal_variables,
                dtype=self.dtype,
                hop_threshold=self.config.get("hybrid hop threshold"),
                device=self.device,
            )
        elif name in SHARDED_SOLVERS:
            # one shard of the BDDs on every rank of the process group (one
            # shard alone without a group), the deltas summed across them
            # every half-sweep; every rank runs this same pipeline
            from bdd_tpu_torch.solver.uniform_sharded import ShardedUniformSolver

            base = ShardedUniformSolver(
                self.pre.collection,
                self.pre.total_nr_variables(),
                obj,
                nr_primal_vars=self.pre.nr_primal_variables,
                dtype=self.dtype,
                partition=self.config.get("partition", "auto"),
                device=self.device,
            )
            if name.startswith("lbfgs"):
                from bdd_tpu_torch.solver.lbfgs import LbfgsSolver

                base = LbfgsSolver(base, **_lbfgs_kwargs(self.config))
            elif name.startswith("subgradient"):
                from bdd_tpu_torch.solver.subgradient import SubgradientSolver

                base = SubgradientSolver(base)
            self.solver = base
        else:  # _check_config admits no other name
            raise ValueError(f"unknown relaxation solver {name!r}")
        return self

    # ------------------------------------------------------------------ solve
    def solve_dual(self, verbose: bool = True) -> float:
        from bdd_tpu_torch.utils.logging import device_trace, span

        t = self.config["termination criteria"]
        self.dual_stats = {}
        with device_trace(label="solve_dual"), span("bdd.solve_dual"):  # BDD_TPU_TRACE=dir
            lb = run_solver(
                self.solver,
                max_iter=t["maximum iterations"],
                tolerance=t["minimum improvement"],
                improvement_slope=t["improvement slope"],
                time_limit=t["time limit"],
                verbose=verbose,
                block_size=getattr(self.solver, "default_block_size", 1),
                stats=self.dual_stats,
            )
        if math.isinf(lb):
            self.infeasible = True
        return lb

    def _rounding_method(self) -> str:
        p = self.config["perturbation rounding"]
        return p.get("method", self.config.get("rounding method", "incremental"))

    def round(self, verbose: bool = True) -> Optional[np.ndarray]:
        p = self.config["perturbation rounding"]
        if p is False:  # dual-only run (rounding disabled)
            return None
        # "incremental" (reference pipeline default), "wedelin", "biased"
        # (objective-tilted tie-breaking) or "best" (run all three, keep the
        # best objective)
        method = self._rounding_method()

        def _incremental(bias: float = 0.0):
            sol = incremental_mm_rounding(
                self.solver,
                init_delta=p["initial perturbation"],
                delta_growth_rate=p["perturbation growth rate"],
                num_itr_lb=p["inner iterations"],
                num_rounding_itr=p["outer iterations"],
                verbose=verbose,
                objective_bias=bias,
                objective=self.pre.objective_vector() if bias else None,
            )
            return None if sol is None else sol[: self.ilp.nr_variables()]

        def _incremental_biased():
            return _incremental(float(p.get("objective bias", 0.5)))

        def _wedelin():
            from bdd_tpu_torch.solver.extras import wedelin_rounding

            sol = wedelin_rounding(self.solver, verbose=verbose)
            return None if sol is None else np.asarray(sol)[: self.ilp.nr_variables()]

        if method == "wedelin":
            return _wedelin()
        if method in ("incremental biased", "biased"):
            return _incremental_biased()
        if method == "best":
            # the heuristics perturb the solver costs in place: snapshot the
            # dual state so each starts from the same converged point (an
            # outer-loop wrapper like LbfgsSolver holds the state on .base)
            target = self.solver
            if not hasattr(target, "state") and hasattr(target, "base"):
                target = target.base
            snap = getattr(target, "state", None)
            best_sol, best_obj = None, math.inf
            for i, fn in enumerate((_incremental, _wedelin, _incremental_biased)):
                if i and snap is not None:
                    target.state = snap
                sol = fn()
                if sol is None:
                    continue
                obj = self.ilp.evaluate([int(v) for v in sol])
                if obj < best_obj:
                    best_sol, best_obj = sol, obj
            return best_sol
        return _incremental()

    # --------------------------------------------------- solver-level queries
    def lower_bound(self) -> float:
        if self.infeasible:
            return math.inf
        if hasattr(self.solver, "lower_bound_with_deferred"):
            return float(self.solver.lower_bound_with_deferred())
        return float(self.solver.lower_bound())

    def _var_names(self):
        if self._ilp is not None:
            return [self.ilp.get_var_name(i) for i in range(self.ilp.nr_variables())]
        return self._native.var_names()

    def min_marginals(self, original_order: bool = True):
        """Per-variable stacked min marginals: list over variables of [n_i, 2]
        arrays (columns m0, m1), one row per BDD containing the variable,
        permuted back to the input order."""
        from bdd_tpu_torch.solver.rounding import min_marginals_per_var

        m0, m1 = self.solver.min_marginals()
        off, m0s, m1s = min_marginals_per_var(self.solver.f, m0, m1)
        per_var = [
            np.stack([m0s[off[v]:off[v + 1]], m1s[off[v]:off[v + 1]]], axis=1)
            for v in range(len(off) - 1)
        ]
        if original_order and self.var_perm is not None:
            n = len(self.var_perm)
            out = list(per_var)
            for new, old in enumerate(self.var_perm):
                out[old] = per_var[new]
            per_var = out[:n] + per_var[n:]
        return per_var

    def min_marginals_with_variable_names(self):
        """(names, mm_lo, mm_hi) flat vectors, one entry per (variable, BDD)
        layer."""
        per_var = self.min_marginals(original_order=False)
        names = self._var_names()
        out_names, lo, hi = [], [], []
        for v, name in enumerate(names):
            for row in per_var[v]:
                out_names.append(name)
                lo.append(float(row[0]))
                hi.append(float(row[1]))
        return out_names, lo, hi

    def fix_variable(self, var, value) -> None:
        """Fix a primal variable (by index or name) to 0/1 in the constructed
        solver."""
        from bdd_tpu_torch.solver.extras import fix_variable

        if isinstance(var, str):
            if self._ilp is not None:
                var = self.ilp.get_var_index(var)
            else:
                var = self._native.var_names().index(var)
        fix_variable(self.solver, int(var), int(value))

    def export_difficult_core(self, path: Optional[str] = None,
                              threshold: Optional[float] = None):
        """Fix variables whose min-marginal sums agree by more than
        ``threshold`` and export the reduced 'difficult core' ILP
        (.lp/.opb/.mps by extension). Returns the reduced ILPInput."""
        from bdd_tpu_torch.solver.rounding import MM_ONE, MM_ZERO, MmDecoder

        path = path if path is not None else self.config.get("export difficult core")
        threshold = threshold if threshold is not None else float(
            self.config.get("export difficult core th", 1e-6))
        # fold pending deferred deltas first: classification from
        # pre-consensus costs fixes the wrong variables
        if hasattr(self.solver, "distribute_delta"):
            self.solver.distribute_delta()
        m0, m1 = self.solver.min_marginals()
        dec = MmDecoder(self.solver.f, np.asarray(m0), np.asarray(m1))
        n = self.ilp.nr_variables()
        one_fix = [v for v in range(n)
                   if dec.types[v] == MM_ONE and dec.sum1[v] + threshold <= dec.sum0[v]]
        zero_fix = [v for v in range(n)
                    if dec.types[v] == MM_ZERO and dec.sum0[v] + threshold <= dec.sum1[v]]
        reduced = self.ilp.reduce(zero_fix, one_fix)
        bdd_log(f"[bdd solver] Difficult core has {reduced.nr_variables()} "
                f"variables and {reduced.nr_constraints()} constraints left")
        if path:
            _write_ilp(reduced, path, "difficult core export file")
        return reduced

    # -------------------------------------------------------- native pipeline
    def _python_pipeline_reason(self) -> Optional[str]:
        """Why this config must go through the Python pipeline; None when
        the native host library can take it."""
        cfg = self.config
        if not cfg.get("use native preprocessing", True):
            return "'use native preprocessing' is off"
        for k in _EXPORT_KEYS:
            if cfg.get(k):
                return f"{k!r} needs the python ILP and BDD collection objects"
        if cfg["relaxation solver"] not in UNIFORM_SOLVERS:
            return f"relaxation solver {cfg['relaxation solver']!r} takes the flat BDD arrays"
        if cfg.get("tighten"):
            return "the tightening phase melds BDDs of the python collection"
        if cfg.get("split chunk size"):
            return "BDD splitting runs in the python pipeline"
        p = cfg.get("perturbation rounding")
        if isinstance(p, dict) and self._rounding_method() != "incremental":
            return f"rounding method {self._rounding_method()!r} runs in the python pipeline"
        return None

    def _try_native(self, verbose: bool, draws: Optional[Draws] = None) -> Optional[Dict]:
        """Native C++ preprocessing fast path (parse + order + BDDs + uniform
        buckets). Returns a result dict when the native pipeline took the
        solve, None when the Python pipeline must (config or input the host
        library does not take); one log line says which and why. Only
        ``NativeUnsupported`` selects the Python pipeline: any other failure
        propagates."""
        reason = self._python_pipeline_reason()
        nh = None
        if reason is None:
            if self._lp_text is None:
                # frontend-built ILPs (UAI MRF, graph matching, generators):
                # serialized through write_lp so they too get the host library
                self._lp_text = self._ilp.write_lp()
            try:
                nh = NativeHost(self._lp_text, self.config["variable order"])
            except NativeUnsupported as exc:
                reason = f"the native host library does not take this input ({exc})"
        if nh is None:
            bdd_log(f"[bdd solver] python preprocessing pipeline: {reason}")
            return None
        bdd_log("[bdd solver] native preprocessing pipeline (C++ host library)")
        self.var_perm = nh.var_perm()  # for min_marginals(original_order)
        if nh.infeasible:
            return {"status": "infeasible", "lower_bound": math.inf}
        host = from_native_host(nh, dtype=self.dtype, device=self.device)
        solver = UniformSolver(host, nh.objective())
        self.solver = solver
        self._native = nh
        self.solve_dual(verbose=verbose)
        if self.infeasible:
            return {"status": "infeasible", "lower_bound": math.inf}
        lb = solver.lower_bound_with_deferred()
        p = self.config["perturbation rounding"]
        sol = None
        if p is not False:
            sol = incremental_mm_rounding_device(
                solver,
                init_delta=p["initial perturbation"],
                delta_growth_rate=p["perturbation growth rate"],
                num_itr_lb=p["inner iterations"],
                num_rounding_itr=p["outer iterations"],
                verbose=verbose,
                draws=draws,
            )
        result = {"status": "solved", "lower_bound": float(lb), **self.dual_stats}
        if sol is not None:
            names = nh.var_names()
            x = [int(v) for v in sol[: len(names)]]
            result["solution"] = dict(zip(names, x))
            result["objective"] = float(np.dot(nh.objective(), np.asarray(x)) + nh.constant())
        return result

    # ----------------------------------------------------------- batched solve
    def solve_batch(self, ilps=None, paths=None, verbose: bool = True,
                    draws: Optional[Draws] = None):
        """Solve several INDEPENDENT ILPs as one batched device program
        (serving mode). Instances share the bucketed tensors; the delta
        exchange never mixes them (disjoint variable spaces). Returns one
        result dict per ILP, with per-instance lower bounds from the per-BDD
        decomposition. The solver must be a uniform-mma variant; rounding and
        termination apply to the joint program."""
        from bdd_tpu_torch.utils.batching import BatchedInstances

        name = self.config["relaxation solver"]
        if name not in UNIFORM_SOLVERS:
            raise ValueError(
                f"solve_batch requires a uniform-mma relaxation solver, got {name!r}")
        if ilps is None:
            ilps = []
            for path in paths:
                sub = BddSolver(dict(self.config), device=self.device)
                sub.read_ilp(path=path)
                ilps.append(sub.ilp)
        n = len(ilps)
        results: list = [None] * n
        pres, live = [], []
        for k, ilp in enumerate(ilps):
            self._reorder(ilp, self.config["variable order"])
            if self.config["normalize constraints"]:
                ilp.normalize()
            try:
                pres.append(BddPreprocessor(
                    ilp,
                    split_chunk_size=self.config["split chunk size"],
                    split_implication_bdd=self.config["split implication"],
                ))
                live.append(k)
            except InfeasibleError:
                results[k] = {"status": "infeasible", "lower_bound": math.inf}
        if not live:
            return results
        bat = BatchedInstances([ilps[k] for k in live], pres=pres)
        solver = UniformSolver.from_collection(
            bat.collection, bat.nr_vars, bat.objective, dtype=self.dtype, device=self.device)
        self.solver = solver
        self.solve_dual(verbose=verbose)
        # per-instance lower bounds from the per-BDD decomposition (a
        # joint-infeasible dual shows up as inf in the affected instances'
        # per-BDD sums below)
        solver.distribute_delta()
        per_bdd = solver.lower_bound_per_bdd()
        bounds = []
        for i, k in enumerate(live):
            b0 = bat.bdd_offsets[i]
            b1 = bat.bdd_offsets[i + 1] if i + 1 < len(live) else bat.collection.nr_bdds()
            bounds.append(float(np.sum(per_bdd[b0:b1])))
        p = self.config["perturbation rounding"]
        sol = None
        if p is not False:
            # 'incremental biased' maps to objective-tilted tie-breaks;
            # 'wedelin'/'best' have no batched device variant: say so
            method = self._rounding_method()
            bias = 0.0
            if method in ("incremental biased", "biased"):
                bias = float(p.get("objective bias", 0.5))
            elif method != "incremental":
                bdd_log(f"[solve_batch] rounding method {method!r} has no "
                        f"batched device variant; using incremental")
            sol = incremental_mm_rounding_device(
                solver,
                init_delta=p["initial perturbation"],
                delta_growth_rate=p["perturbation growth rate"],
                num_itr_lb=p["inner iterations"],
                num_rounding_itr=p["outer iterations"],
                verbose=verbose,
                objective_bias=bias,
                objective=np.asarray(bat.objective) if bias else None,
                draws=draws,
            )
        for i, k in enumerate(live):
            ilp = ilps[k]
            res = {"status": "solved", "lower_bound": bounds[i]}
            if math.isinf(bounds[i]):
                res = {"status": "infeasible", "lower_bound": math.inf}
            elif sol is not None:
                xs = bat.slice_solution(np.asarray(sol), i)
                x = [int(v) for v in xs[: ilp.nr_variables()]]
                if ilp.feasible(x):
                    res["solution"] = {
                        ilp.get_var_name(j): x[j] for j in range(ilp.nr_variables())
                    }
                    res["objective"] = float(ilp.evaluate(x))
            results[k] = res
        return results

    def _tighten_phase(self, verbose: bool) -> float:
        """The cut-tightening phase (config key ``"tighten"``: true or
        {"cliques", "odd cycles", "eps", "node limit"}; api.py:832-918 of the
        JAX package): meld BDD groups around tight variables (clique and odd
        cycle facets of the conflict graph by default) and re-solve WARM from
        the transferred converged duals on the device. Returns the lower
        bound; the solver from before is kept when the re-solve ends below
        the bound it started from. ``tighten_stats`` keeps the counts and
        the wall seconds of each step."""
        from bdd_tpu_torch.solver.tighten import (
            conflict_cuts,
            tight_variables,
            tighten_collection,
        )

        t_cfg = self.config["tighten"]
        if not isinstance(t_cfg, dict):
            t_cfg = {}
        s = self.solver
        if not hasattr(s, "export_layer_costs") and hasattr(s, "base"):
            s = s.base
        lb0 = float(s.lower_bound_with_deferred())
        if not all(hasattr(s, a) for a in ("export_layer_costs", "min_marginals", "f")):
            bdd_log("[tighten] solver exposes no layer costs — skipped")
            return lb0
        stats = self.tighten_stats
        stats.update(dual_s=self.dual_stats.get("solve_time"),
                     dual_iterations=self.dual_stats.get("iterations"))
        t0 = time.perf_counter()
        s.distribute_delta()
        m0, m1 = s.min_marginals()
        tv = tight_variables(s.f, m0, m1, eps=float(t_cfg.get("eps", 1e-4)))
        costs = s.export_layer_costs()
        t1 = time.perf_counter()
        explicit = None
        if t_cfg.get("cliques", True) or t_cfg.get("odd cycles", True):
            explicit = conflict_cuts(
                self.pre.collection,
                tv,
                cliques=t_cfg.get("cliques", True),
                odd_cycles=t_cfg.get("odd cycles", True),
            ) or None
        new_col, new_costs, groups = tighten_collection(
            self.pre.collection,
            tv,
            layer_costs=costs,
            node_limit=int(t_cfg.get("node limit", 200000)),
            explicit_groups=explicit,
        )
        t2 = time.perf_counter()
        melded = sum(1 for g in groups.values() if len(g) > 1)
        stats.update(min_marginals_s=t1 - t0, meld_s=t2 - t1, tight_variables=len(tv),
                     groups_melded=melded, bdds_before=self.pre.collection.nr_bdds(),
                     bdds_after=new_col.nr_bdds())
        if melded == 0:
            bdd_log("[tighten] no groups melded")
            return lb0
        bdd_log(
            f"[tighten] {melded} groups melded "
            f"({'clique facets' if explicit else 'tight-variable clusters'}),"
            f" bdds {self.pre.collection.nr_bdds()} -> {new_col.nr_bdds()}"
        )
        pre_solver = self.solver
        self.solver = UniformSolver.from_collection(
            new_col,
            self.pre.total_nr_variables(),
            self.pre.objective_vector(),
            nr_primal_vars=self.pre.nr_primal_variables,
            dtype=self.dtype,
            device=self.device,
            layer_costs=new_costs,
        )
        t3 = time.perf_counter()
        self.solve_dual(verbose=verbose)
        lb = float(self.solver.lower_bound_with_deferred())
        stats.update(rebuild_s=t3 - t2, resolve_s=time.perf_counter() - t3,
                     warm_lower_bound=self.dual_stats.get("initial_lower_bound"))
        bdd_log(f"[tighten] lower bound {lb0:.6f} -> {lb:.6f}")
        self._tighten_bounds = (lb0, lb)
        if lb < lb0:
            # the warm re-solve did not recover the pre-tighten bound in
            # budget: keep the original solver, so that the bound reported is
            # the one the state that rounding runs on holds
            self.solver = pre_solver
            return lb0
        return lb

    def solve(self, verbose: bool = True, draws: Optional[Draws] = None) -> Dict:
        """Full pipeline; returns the result dict of ``bdd_tpu.api``.
        ``draws``: optional uniform draws for the device rounding of the
        native pipeline (see ``incremental_mm_rounding_device``)."""
        if self._ilp is None and self._lp_text is None:
            self.read_ilp()
        native_result = self._try_native(verbose, draws)
        if native_result is not None:
            return native_result
        self.process_ilp()
        self.export_lp_file()
        try:
            self.transform_to_bdds()
        except InfeasibleError:
            return {"status": "infeasible", "lower_bound": math.inf}
        self.print_statistics()
        self.export_bdd_graph()
        self.export_bdd_lp_file()
        self.construct_solver()
        lb = self.solve_dual(verbose=verbose)
        if self.infeasible:
            return {"status": "infeasible", "lower_bound": math.inf}
        if hasattr(self.solver, "lower_bound_with_deferred"):
            lb = self.solver.lower_bound_with_deferred()
        if self.config.get("tighten"):
            lb = self._tighten_phase(verbose)
        if self.config.get("export difficult core"):
            self.export_difficult_core()
        sol = self.round(verbose=verbose)
        if hasattr(self.solver, "close"):
            self.solver.close()  # hybrid mma: release the worker thread
        result = {"status": "solved", "lower_bound": float(lb), **self.dual_stats}
        tb = getattr(self, "_tighten_bounds", None)
        if tb is not None:
            result["tighten"] = {"pre_lower_bound": float(tb[0]),
                                 "post_lower_bound": float(tb[1])}
        if sol is not None:
            x = [int(v) for v in sol]
            result["solution"] = {
                self.ilp.get_var_name(i): x[i] for i in range(self.ilp.nr_variables())
            }
            result["objective"] = float(self.ilp.evaluate(x))
        return result


def main(argv=None) -> int:
    """CLI: ``python -m bdd_tpu_torch.api <config.json | problem.lp> [--device
    cuda]``. A config with an ``"inputs"`` list is solved as one batch. A
    sharded solver under a launcher that sets WORLD_SIZE > 1 (``torchrun
    --nproc_per_node=D -m bdd_tpu_torch.api cfg.json``) joins the launcher's
    process group first; every rank solves, rank 0 prints."""
    import os

    from bdd_tpu_torch.utils import multihost

    ap = argparse.ArgumentParser(prog="python -m bdd_tpu_torch.api")
    ap.add_argument("input", help="config .json or problem .lp")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.input.endswith(".json"):
        with open(args.input) as fh:
            config = json.load(fh)
    else:
        config = {"input": args.input}
    if (config.get("relaxation solver") in SHARDED_SOLVERS
            and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        multihost.initialize(platform=torch.device(args.device).type)
    solver = BddSolver(config, device=args.device)
    if "inputs" in solver.config:  # batched serving mode
        result = solver.solve_batch(paths=solver.config["inputs"])
    else:
        result = solver.solve()
    if multihost.process_index() == 0:
        bdd_log(json.dumps(result, indent=2, default=str))
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
