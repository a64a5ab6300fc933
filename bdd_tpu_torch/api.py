"""Top-level solver for the native main path + CLI (counterpart of
bdd_tpu/api.py: ``_try_native`` + ``solve``, api.py:608-712 and 920-926).

    LP text -> C++ host library (parse, order, BDDs, buckets) -> uniform MMA
    dual ascent on the device -> on-device incremental rounding.

The device is explicit (default ``"cuda"``). Configurations outside this
path raise ``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, Optional

import numpy as np
import torch

from bdd_tpu_torch.native import NativeHost, NativeUnsupported
from bdd_tpu_torch.solver.run import run_solver
from bdd_tpu_torch.utils.logging import bdd_log
from bdd_tpu_torch.solver.layout import from_native_host, resolve_device
from bdd_tpu_torch.solver.rounding_device import Draws, incremental_mm_rounding_device
from bdd_tpu_torch.solver.uniform_wrapper import UniformSolver

# api.py:31-59 of the JAX package
DEFAULT_CONFIG = {
    "variable order": "input",  # input|bfs|minimum degree|cuthill
    "use native preprocessing": True,
    "normalize constraints": True,
    "precision": "float",  # float|double
    "relaxation solver": "uniform mma",
    "split chunk size": None,
    "split implication": False,
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
_NATIVE_ORDERS = ("input", "bfs", "cuthill", "minimum degree", "mindegree")

# config key -> ROADMAP.md item that ports it
_NOT_PORTED = {
    "export lp": "Queue 1 item 7 (the python pipeline and exports)",
    "export bdd lp": "Queue 1 item 7 (the python pipeline and exports)",
    "export bdd graph": "Queue 1 item 7 (the python pipeline and exports)",
    "print statistics": "Queue 1 item 7 (the python pipeline and exports)",
    "export difficult core": "Queue 1 item 7 (the python pipeline and exports)",
    "split chunk size": "Queue 1 item 7 (the python pipeline: BDD splitting)",
    "split bdds": "Queue 1 item 7 (the python pipeline: BDD splitting)",
    "tighten": "Queue 1 item 10 (tightening)",
    "smoothing": "Queue 1 item 11 (smooth solvers)",
    "inputs": "Queue 1 item 8 (batched solves)",
}


def _merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            out[k] = _merge(base[k], v)
        else:
            out[k] = v
    return out


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to bdd_tpu_torch yet: see ROADMAP.md {item}"
    )


class BddSolver:
    """The native main path of ``bdd_tpu.api.BddSolver`` on one device."""

    def __init__(self, config: Optional[dict] = None, device="cuda", **kwargs) -> None:
        config = _merge(DEFAULT_CONFIG, config or {})
        self.config = _merge(config, kwargs)
        self.device = resolve_device(device)
        self._lp_text: Optional[str] = None
        self.solver: Optional[UniformSolver] = None
        self.var_perm = None
        self.dual_stats: dict = {}
        self._check_config()

    def _check_config(self) -> None:
        cfg = self.config
        for key, item in _NOT_PORTED.items():
            value = cfg.get(key)
            # "split bdds": {} asks for splitting with an automatic length
            if value or (key == "split bdds" and value not in (None, False)):
                raise _not_ported(f"config key {key!r}", item)
        name = cfg["relaxation solver"]
        if name not in UNIFORM_SOLVERS:
            raise _not_ported(
                f"relaxation solver {name!r}",
                "Queue 1 items 7-15 (host solvers, outer loops, smooth, learned, "
                "multi-device, hybrid, dense)",
            )
        if not cfg.get("use native preprocessing", True):
            raise _not_ported("the python preprocessing pipeline", "Queue 1 item 7")
        p = cfg["perturbation rounding"]
        if p is not False:
            method = p.get("method", cfg.get("rounding method", "incremental"))
            if method != "incremental":
                raise _not_ported(f"rounding method {method!r}", "Queue 1 item 7")
        if cfg["precision"] not in ("float", "double"):
            raise ValueError(f"unknown precision {cfg['precision']!r}")

    # ------------------------------------------------------------------ input
    def read_ilp(self, ilp=None, path: Optional[str] = None, lp_string: Optional[str] = None):
        """LP text, an .lp path, or an ILP object (e.g. from the shared
        frontends), which is serialized through ``write_lp`` for the native
        host library as the JAX package does (api.py:630-642)."""
        if ilp is not None:
            self._lp_text = ilp.write_lp()
        elif lp_string is not None:
            self._lp_text = lp_string
        else:
            path = path if path is not None else self.config.get("input")
            if path is None:
                raise ValueError("no input given")
            if not path.endswith(".lp"):
                raise _not_ported(f"input {path!r} (only .lp files)", "Queue 1 item 7")
            with open(path) as fh:
                self._lp_text = fh.read()
        return self

    # ------------------------------------------------------------------ solve
    def _native_host(self) -> NativeHost:
        order = self.config["variable order"]
        try:
            nh = NativeHost(self._lp_text, order if order in _NATIVE_ORDERS else "input")
        except NativeUnsupported as exc:
            raise _not_ported(f"this input ({exc})", "Queue 1 item 7") from exc
        self.var_perm = nh.var_perm()
        return nh

    def solve_dual(self, verbose: bool = True) -> float:
        t = self.config["termination criteria"]
        self.dual_stats = {}
        return run_solver(
            self.solver,
            max_iter=t["maximum iterations"],
            tolerance=t["minimum improvement"],
            improvement_slope=t["improvement slope"],
            time_limit=t["time limit"],
            verbose=verbose,
            block_size=self.solver.default_block_size,
            stats=self.dual_stats,
        )

    def solve(self, verbose: bool = True, draws: Optional[Draws] = None) -> Dict:
        """Full pipeline; returns the result dict of ``bdd_tpu.api``.
        ``draws``: optional uniform draws for the rounding (see
        ``incremental_mm_rounding_device``)."""
        if self._lp_text is None:
            self.read_ilp()
        nh = self._native_host()
        if nh.infeasible:
            return {"status": "infeasible", "lower_bound": math.inf}
        dtype = torch.float64 if self.config["precision"] == "double" else torch.float32
        host = from_native_host(nh, dtype=dtype, device=self.device)
        self.solver = UniformSolver(host, nh.objective())
        lb = self.solve_dual(verbose=verbose)
        if math.isinf(lb):
            return {"status": "infeasible", "lower_bound": math.inf}
        lb = self.solver.lower_bound_with_deferred()
        p = self.config["perturbation rounding"]
        sol = None
        if p is not False:
            sol = incremental_mm_rounding_device(
                self.solver,
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


def main(argv=None) -> int:
    """CLI: ``python -m bdd_tpu_torch.api config.json [--device cuda]``."""
    ap = argparse.ArgumentParser(prog="python -m bdd_tpu_torch.api")
    ap.add_argument("input", help="config .json or problem .lp")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.input.endswith(".json"):
        with open(args.input) as fh:
            solver = BddSolver(json.load(fh), device=args.device)
    else:
        solver = BddSolver({"input": args.input}, device=args.device)
    result = solver.solve()
    bdd_log(json.dumps(result, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
