"""Disk-backed DOGE dataset, ground truth, and dual-converged caches.

Port of bdd_tpu/learn/data.py (ref: DOGE/data/disk_dataloader.py,
gt_generator.py, write_dual_solved.py): a root directory of ILP instance
files is walked recursively, per-instance artifacts are cached next to the
instance and in a parallel ``solutions/`` tree, and the dataset is indexed by
file size (the largest instances last, the reference's memory policy):

  <name><ext>                          the instance (.lp / .opb)
  <name>_bdd_repr.pkl                  preprocessed solver representation
  <name>_bdd_repr_dual_converged.pkl   + converged per-layer float64 duals
  <root>/../solutions/<name>.pkl       ground truth {lp_stats, ilp_stats}

Skip markers in file names (``nan``, ``normalized``, ``slow_bdd``,
``_one_con``, ``oom``, ``too_easy``), the ``_error_bdd`` rename and retry,
the ``files_to_load`` filter and the ``{'time', 'obj', 'sol_dict'}``
ground-truth schema are the JAX package's.

Ground truth comes from this package: ``lp_stats`` from the converged dual
bound of the native float64 OpenMP solver, ``ilp_stats`` from the full solve
with rounding. Dual-converged states come from the same native solver and are
carried into the uniform layout exactly, as (lo, hi, deferred marginal) per
layer.

The representation cache holds numpy arrays only (``layout.host_to_arrays``,
the objective, the static ILP features of the graph), so a cache written on
one device loads on any other. It is a pickle, and a pickle runs code when
loaded: point the dataset only at directories this package or the JAX
package wrote (the JAX package's caches hold JAX types and do not load here).

CLI: ``python -m bdd_tpu_torch.learn.data <root> [--converged] [--gt]
[--ilp-gt] [--device cpu]``.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bdd_tpu_torch.learn import features as ft
from bdd_tpu_torch.learn.train import Instance
from bdd_tpu_torch.solver import layout

_SKIP_MARKERS = ("nan", "normalized", "slow_bdd", "_one_con", "oom", "too_easy")
_EMPTY_SOL = {"time": None, "obj": None, "sol_dict": None, "sol": None}


# ------------------------------------------------------------------ ilp loading
def read_any_ilp(path: str):
    """Parse an instance file by extension (.lp / .opb)."""
    if path.endswith(".opb"):
        from bdd_tpu_torch.ilp.opb_parser import parse_opb_file

        return parse_opb_file(path)
    from bdd_tpu_torch.ilp.lp_parser import parse_lp_file

    return parse_lp_file(path)


def _native_converged(pre, improvement: float, max_iterations: int, omega: float = 0.5):
    """The native float64 solver run in blocks of 1,000 iterations until the
    bound moves by at most ``improvement`` (relative) over a block."""
    from bdd_tpu_torch import native

    cs = native.cpu_solver_from_collection(pre.collection, pre.total_nr_variables(),
                                           pre.objective_vector())
    prev = -np.inf
    it = 0
    while it < max_iterations:
        block = min(1000, max_iterations - it)
        cs.iterations(block, omega)
        it += block
        lb = cs.lower_bound_with_deferred()
        if abs(lb - prev) <= improvement * max(abs(lb), 1.0):
            break
        prev = lb
    return cs


# --------------------------------------------------------------- ground truth
def generate_gt(path: str, need_ilp_gt: bool = True, max_dual_iterations: int = 50000,
                improvement: float = 1e-9, device="cuda") -> Tuple[dict, Optional[dict]]:
    """Ground truth from this package (data.py:85-147). lp_stats: the
    converged Lagrangian bound of the native float64 solver (no primal
    vector: ``sol_dict`` None). ilp_stats: the best integral solution of the
    solve with rounding on ``device`` (an upper bound, optimal only when the
    gap closes), or None when it finds none."""
    from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor

    ilp = read_any_ilp(path)
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    t0 = time.time()
    cs = _native_converged(pre, improvement, max_dual_iterations)
    lp_stats = {"time": time.time() - t0, "obj": cs.lower_bound_with_deferred() + ilp.constant_,
                "sol_dict": None}
    ilp_stats = None
    if need_ilp_gt:
        from bdd_tpu_torch.api import BddSolver

        t0 = time.time()
        s = BddSolver({"relaxation solver": "uniform mma", "rounding method": "best",
                       "termination criteria": {"maximum iterations": 10000,
                                                "time limit": 600}}, device=device)
        s.read_ilp(ilp=read_any_ilp(path))
        res = s.solve(verbose=False)
        if res.get("objective") is not None:
            ilp_stats = {"time": time.time() - t0, "obj": res["objective"],
                         "sol_dict": res.get("solution")}
    return lp_stats, ilp_stats


# ------------------------------------------------------ dual-converged duals
def converged_layer_costs(pre, improvement: float = 1e-6, max_iterations: int = 50000,
                          omega: float = 0.5) -> Dict[Tuple[int, int], Tuple[float, float, float]]:
    """The native float64 solver run to convergence, its state as {(bdd, var):
    (lo, hi, deferred_mm)}: the input of
    ``uniform.init_uniform_state_from_layer_costs`` (data.py:150-181)."""
    cs = _native_converged(pre, improvement, max_iterations, omega)
    cb, cv = cs.layer_info()
    lo, hi, mm = cs.costs()
    return {(int(b), int(v)): (float(l), float(h), float(m))
            for b, v, l, h, m in zip(cb, cv, lo, hi, mm)}


# ------------------------------------------------------------------- dataset
class IlpDiskDataset:
    """Disk dataset of ILP instances with cached solver representations
    (data.py:184-375; ref: DOGE/data/disk_dataloader.py ILPDiskDataset).
    ``dtype`` and ``device``: those of the instances it hands out."""

    def __init__(self, data_root_dir: str, files_to_load: Sequence[str] = (),
                 read_dual_converged: bool = False, need_gt: bool = False,
                 need_ilp_gt: bool = False, load_in_memory: bool = False,
                 skip_dual_solved: bool = False, extension: str = ".lp",
                 dtype=torch.float32, device="cuda", verbose: bool = True) -> None:
        self.data_root_dir = data_root_dir
        self.files_to_load = list(files_to_load)
        self.read_dual_converged = read_dual_converged
        self.need_gt = need_gt
        self.need_ilp_gt = need_ilp_gt
        self.load_in_memory = load_in_memory
        self.skip_dual_solved = skip_dual_solved
        self.extension = extension
        self.dtype = dtype
        self.device = layout.resolve_device(device)
        self.verbose = verbose
        self.file_list: List[dict] = []
        self._memory: List[tuple] = []
        self._scan()

    @classmethod
    def from_config(cls, cfg: dict, con_features: Sequence[str] = (),
                    skip_dual_solved: bool = False, device="cuda"):
        """The reference's from_config: ``cfg`` is the {root_dir,
        files_to_load, read_dual_converged, ...} params dict."""
        return cls(data_root_dir=cfg["root_dir"], files_to_load=cfg.get("files_to_load", ()),
                   read_dual_converged=cfg.get("read_dual_converged", False),
                   need_gt=cfg.get("need_gt", False), need_ilp_gt=cfg.get("need_ilp_gt", False),
                   load_in_memory=cfg.get("load_in_memory", False),
                   skip_dual_solved=skip_dual_solved, extension=cfg.get("extension", ".lp"),
                   device=device)

    # ------------------------------------------------------------- discovery
    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg, flush=True)

    def _sol_path(self, path: str, name: str) -> str:
        d = os.path.dirname(path)
        sol_dir = (d.replace("instances", "solutions") if "instances" in d
                   else os.path.join(d, "solutions"))
        return os.path.join(sol_dir, name[: -len(self.extension)] + ".pkl")

    def _scan(self) -> None:
        for path, _subdirs, fnames in os.walk(self.data_root_dir):
            if os.path.basename(path) == "solutions":
                continue
            for name in sorted(fnames):
                if not name.endswith(self.extension):
                    continue
                if any(m in name for m in _SKIP_MARKERS) or "_bdd_repr" in name:
                    continue
                fpath = os.path.join(path, name)
                if "error_bdd" in name:
                    # a previous conversion failed; retry under the clean name
                    clean = name.replace("_error_bdd" + self.extension, self.extension)
                    os.rename(fpath, os.path.join(path, clean))
                    name, fpath = clean, os.path.join(path, clean)
                sol_name = name
                if "dual_solved" in name:
                    if self.skip_dual_solved:
                        continue
                    sol_name = name.replace("_dual_solved", "")
                if self.files_to_load and name not in self.files_to_load:
                    continue
                entry = self._prepare(fpath, name, sol_name)
                if entry is not None:
                    self.file_list.append(entry)
        self.file_list.sort(key=lambda e: e["lp_size"])
        if self.load_in_memory:
            self._log(f"# loading {len(self.file_list)} instances in memory")
            self._memory = [self._from_disk(i) for i in range(len(self.file_list))]

    # ----------------------------------------------------------- cache build
    def _prepare(self, fpath: str, name: str, sol_name: str) -> Optional[dict]:
        sol_path = self._sol_path(fpath, sol_name)
        if not os.path.exists(sol_path):
            os.makedirs(os.path.dirname(sol_path), exist_ok=True)
            if self.need_gt:
                self._log(f"# generating ground truth: {fpath}")
                lp_stats, ilp_stats = generate_gt(fpath, self.need_ilp_gt, device=self.device)
                gt_info = {"lp_stats": lp_stats,
                           "ilp_stats": ilp_stats if ilp_stats is not None else dict(_EMPTY_SOL)}
            else:
                gt_info = {"lp_stats": dict(_EMPTY_SOL), "ilp_stats": dict(_EMPTY_SOL)}
            with open(sol_path, "wb") as fh:
                pickle.dump(gt_info, fh)
        stem = fpath[: -len(self.extension)]
        repr_path = stem + "_bdd_repr.pkl"
        conv_path = stem + "_bdd_repr_dual_converged.pkl"
        if not os.path.exists(repr_path):
            self._log(f"# creating BDD repr: {fpath}")
            try:
                inst = Instance.from_ilp(read_any_ilp(fpath), dtype=self.dtype,
                                         device=self.device)
            except Exception as e:  # noqa: BLE001 - any failed conversion renames the file
                self._log(f"# BDD conversion failed ({e!r}); renaming")
                os.rename(fpath, stem + "_error_bdd" + self.extension)
                return None
            spec = inst.spec
            static = (None if spec.coeff is None else
                      tuple(t.cpu().numpy() for t in (spec.coeff, spec.rhs, spec.con_type)))
            with open(repr_path, "wb") as fh:
                pickle.dump({"host": layout.host_to_arrays(inst.host),
                             "objective": inst.objective.cpu().numpy().astype(np.float64),
                             "static": static}, fh, protocol=pickle.HIGHEST_PROTOCOL)
        if self.read_dual_converged and not os.path.exists(conv_path):
            self._log(f"# solving BDD dual to convergence: {fpath}")
            from bdd_tpu_torch.bdd.preprocessor import BddPreprocessor

            ilp = read_any_ilp(fpath)
            ilp.normalize()
            with open(conv_path, "wb") as fh:
                pickle.dump(converged_layer_costs(BddPreprocessor(ilp)), fh,
                            protocol=pickle.HIGHEST_PROTOCOL)
        return {"instance_path": fpath, "bdd_repr_path": repr_path,
                "conv_path": conv_path if self.read_dual_converged else None,
                "sol_path": sol_path, "lp_size": os.path.getsize(fpath)}

    # ---------------------------------------------------------------- access
    def __len__(self) -> int:
        return len(self.file_list)

    def _from_disk(self, index: int) -> tuple:
        e = self.file_list[index]
        with open(e["bdd_repr_path"], "rb") as fh:
            rep = pickle.load(fh)
        layer_costs = None
        if e["conv_path"]:
            with open(e["conv_path"], "rb") as fh:
                layer_costs = pickle.load(fh)
        with open(e["sol_path"], "rb") as fh:
            gt_info = pickle.load(fh)
        host = layout.host_from_arrays(rep["host"], self.dtype, self.device)
        spec = ft.graph_spec(host, static=rep["static"])
        inst = Instance.from_cached(host, rep["objective"], spec, layer_costs=layer_costs)
        return inst, gt_info, e["instance_path"]

    def get(self, index: int) -> tuple:
        """(Instance, gt_info, instance_path); the instance's state0 carries the
        converged duals when read_dual_converged."""
        if self.load_in_memory:
            return self._memory[index]
        return self._from_disk(index)

    def __getitem__(self, index: int) -> tuple:
        return self.get(index)


# ----------------------------------------------------------------------- CLI
def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Pre-generate the dataset caches")
    ap.add_argument("root")
    ap.add_argument("--converged", action="store_true",
                    help="also cache converged duals (native float64)")
    ap.add_argument("--gt", action="store_true", help="generate ground-truth bounds")
    ap.add_argument("--ilp-gt", action="store_true",
                    help="also round an integral solution for the ground truth")
    ap.add_argument("--extension", default=".lp")
    ap.add_argument("--device", default="cuda", help="where instances are built (cuda or cpu)")
    args = ap.parse_args(argv)
    ds = IlpDiskDataset(args.root, read_dual_converged=args.converged, need_gt=args.gt,
                        need_ilp_gt=args.ilp_gt, extension=args.extension, device=args.device)
    print(f"# {len(ds)} instances prepared under {args.root}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
